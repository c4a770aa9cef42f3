"""Configs of the port: the architectures (DeepSpeech2 and the dense LMs
the serving path runs), the FL experiment and the precision levels.

The fields and defaults are those of the JAX package's ``configs/base.py``,
``configs/deepspeech2_paper.py``, ``configs/stablelm_1p6b.py`` and
``configs/qwen3_8b.py``, cut to what the federated round and the dense
serving path read. Every config is a frozen dataclass, so configs hash and
compare.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

# symbols per f32 scale on the uplink wire (blockwise scales)
QUANT_BLOCK = 256


@dataclass(frozen=True)
class ArchConfig:
    """The architecture fields the DeepSpeech2 model and the dense LM
    family read."""

    name: str
    family: str  # "ds2" | "dense"
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 1
    n_kv_heads: int = 1
    d_ff: int = 0
    source: str = ""
    # attention flavour
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    frontend_dim: int = 0
    # sliding-window KV cache size for long-context decode
    window: int = 8192
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # query/key chunk of the plain chunked attention
    attn_chunk: int = 1024
    # route causal prefill attention through the flash kernel
    # (kernels/flash_attention.py); windowed, non-causal and differentiable
    # attention keep the chunked path
    use_flash_kernel: bool = False

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model <= 256, <= 4 heads, f32."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads) if self.n_kv_heads else 0
        kw: Dict[str, Any] = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=max(1, n_kv),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=0,
            window=64,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.frontend_dim:
            kw.update(frontend_dim=d_model)
        return self.with_(**kw)


@dataclass(frozen=True)
class PrecisionLevel:
    """One selectable client precision level (see the JAX package's
    ``configs/base.py`` for the model behind each curve)."""

    bits: int

    @property
    def rel_energy(self) -> float:
        compute = (self.bits / 32.0) ** 0.9
        overhead = (self.bits / 32.0) ** 0.45
        return 0.55 * compute + 0.45 * overhead

    @property
    def rel_latency(self) -> float:
        return 0.5 * (self.bits / 32.0) + 0.5 * (self.bits / 32.0) ** 0.5

    @property
    def rel_accuracy(self) -> float:
        return {4: 0.75, 8: 0.93, 16: 0.99, 32: 1.0}[self.bits]

    @property
    def noise_sensitivity(self) -> float:
        return {4: 0.35, 8: 0.15, 16: 0.05, 32: 0.02}[self.bits]


PRECISION_LEVELS: Tuple[PrecisionLevel, ...] = tuple(
    PrecisionLevel(b) for b in (4, 8, 16, 32)
)
BITS_TO_LEVEL = {p.bits: p for p in PRECISION_LEVELS}


@dataclass(frozen=True)
class FLConfig:
    n_clients: int = 100
    clients_per_round: int = 20
    n_rounds: int = 100
    local_steps: int = 4
    local_batch: int = 8
    lr: float = 5e-4
    strategy: str = "fedavg"  # fedavg | class_equal | majority_centric
    planner: str = "rag"  # rag | unified | rag_energy
    snr_db: float = 20.0
    quant_block: int = QUANT_BLOCK
    seed: int = 0
    # physical OTA channel (core/channel.py): "ideal" is the coin-flip +
    # AWGN path; "fading" draws per-client Rayleigh gains with truncated
    # channel inversion under the transmit power budget
    channel_model: str = "ideal"  # ideal | fading
    fade_threshold: float = 0.1  # |h|^2 truncation threshold
    tx_power_budget: float = 100.0  # per-client max transmit power P
    pathloss_spread_db: float = 0.0  # log-normal shadowing std (dB)
    downlink_bits: int = 32
    downlink_block: int = QUANT_BLOCK
    dropout_prob: float = 0.0
    fedprox_mu: float = 0.0
    server_momentum: float = 0.0
    quantize_server_state: bool = False
    # paper Table II category mixture (unused by the round loops, as in
    # the reference)
    categories: Tuple[str, ...] = (
        "entertainment",
        "smart_home",
        "general_query",
        "personal_request",
    )
    category_probs: Tuple[float, ...] = (0.327, 0.160, 0.319, 0.194)


def deepspeech2() -> ArchConfig:
    """The paper's DeepSpeech2-style ASR model: 3 bi-GRU layers of 256,
    80 mel features, a 64-symbol vocabulary (arXiv:1512.02595)."""
    return ArchConfig(
        name="deepspeech2",
        family="ds2",
        n_layers=3,
        d_model=256,
        vocab_size=64,
        frontend_dim=80,
        source="arXiv:1512.02595",
    )


def stablelm_1p6b() -> ArchConfig:
    """stablelm-1.6b: dense, MHA (32 heads of 64)."""
    return ArchConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab_size=100_352,
        source="hf:stabilityai/stablelm-2-1_6b",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def qwen3_8b() -> ArchConfig:
    """qwen3-8b: dense, GQA (32 query heads over 8 KV heads of 128),
    qk-norm, RoPE theta 1e6, untied embeddings."""
    return ArchConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12288,
        vocab_size=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-8B",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


ARCH_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {
    "deepspeech2": deepspeech2,
    "stablelm-1.6b": stablelm_1p6b,
    "qwen3-8b": qwen3_8b,
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]()
