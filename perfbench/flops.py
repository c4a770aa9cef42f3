"""Operation counts of a training step, from a configuration's sizes and
the step's batch; the yardstick of ``mfu`` and the layer rooflines.

Model FLOPs of a step: 6 x the matrix params a token passes x tokens
(forward 2, backward 4; a weight-shared block counted at each
application, the head included, the embedding's gather not), plus causal
attention's QK^T and PV over the pairs a causal mask keeps, forward and
backward (3 x the forward), plus the Mamba-2 scan's operations, forward
and backward (3 x the forward). Recomputation is not counted.

``ssd_forward_flops`` is the program's chunked scan counted operation by
operation (chunk 64), a frozen copy of ``chip_smoke._ssd_f32_flops``.
"""

from __future__ import annotations

from typing import Dict

BF16_PEAK = 989e12  # H100 SXM, dense bf16 tensor cores (NVIDIA's data sheet)
SSD_CHUNK = 64


def attention_forward_flops(cfg: Dict, B: int, S: int) -> float:
    """QK^T and PV of one causal attention over B x S tokens: 2 products
    of 2 H D flops a kept (query, key) pair, S (S + 1) / 2 pairs a row."""
    return 2.0 * 2.0 * B * cfg["n_heads"] * cfg["head_dim"] * S * (S + 1) / 2


def ssd_forward_flops(cfg: Dict, B: int, S: int) -> float:
    """f32 operations of one Mamba-2 chunked scan over B x S: the
    intra-chunk scores (C B^T) and their decay weights, the products with
    x dt, the chunk states' weighting and product with B, the inter-chunk
    recurrence, the entering states' product with C and its decay."""
    H = cfg["ssm_heads"]
    P, N = cfg["d_inner"] // H, cfg["ssm_state"]
    L = min(SSD_CHUNK, S)
    bc = float(B * -(-S // L))
    return bc * (2.0 * L * L * N + 4.0 * L * L * H + 2.0 * H * L * L * P
                 + L * H * P + 2.0 * L * H * P * N + 2.0 * H * P * N
                 + 2.0 * L * N * H * P + L * H * P)


def attention_block_params(cfg: Dict) -> int:
    d, H, KV, Dh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    return d * (H + 2 * KV) * Dh + H * Dh * d


def train_step_flops(family, cfg: Dict, B: int, S: int) -> Dict[str, float]:
    """A step's model FLOPs, whole and by part; ``family`` is the
    configuration's module under ``perfbench/reference`` (its
    ``matrix_params`` and ``applications``)."""
    apps = family.applications(cfg)
    matmul = 6.0 * family.matrix_params(cfg) * B * S
    attn = 3.0 * apps.get("attention", 0) * attention_forward_flops(cfg, B, S)
    ssd = 3.0 * apps.get("ssd", 0) * ssd_forward_flops(cfg, B, S) if apps.get("ssd") else 0.0
    return {"matmul": matmul, "attention": attn, "ssd": ssd, "total": matmul + attn + ssd}
