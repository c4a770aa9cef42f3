"""The step's attention, timed from outside: the program's
``models.layers.chunked_attention`` at the step's shapes in the compute
dtype, forward and forward with backward between CUDA events, times the
applications a step makes (under remat its forward runs twice)."""

from __future__ import annotations

import torch

from perfbench import flops
from perfbench.profiling import cuda_ms


def measure(ctx) -> dict:
    from repro_torch.models import layers as L

    cfg, B, S, dev = ctx.cfg, ctx.batch, ctx.seq, ctx.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dt = getattr(torch, cfg["compute_dtype"])
    shape = (B, S, cfg["n_heads"], cfg["head_dim"])
    kv_shape = (B, S, cfg["n_kv_heads"], cfg["head_dim"])
    q = torch.randn(shape, generator=gen, device=dev, dtype=dt).requires_grad_(True)
    k, v = (torch.randn(kv_shape, generator=gen, device=dev, dtype=dt).requires_grad_(True)
            for _ in range(2))
    g = torch.randn(shape, generator=gen, device=dev, dtype=dt)
    chunk = cfg["attn_chunk"]

    def fwd():
        return L.chunked_attention(q, k, v, causal=True, q_chunk=chunk, k_chunk=chunk)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q, k, v), g)

    with torch.no_grad():
        f_ms = cuda_ms(fwd)
    fb_ms = cuda_ms(fwd_bwd)
    apps = ctx.family.applications(cfg)["attention"]
    again = cfg["probes"]["attention"]["recomputed"]
    return {"forward_ms": f_ms, "forward_backward_ms": fb_ms, "applications": apps,
            "step_ms": apps * (fb_ms + (f_ms if again else 0.0)),
            "model_flops": 3.0 * apps * flops.attention_forward_flops(cfg, B, S)}
