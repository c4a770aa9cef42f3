"""The step's Mamba-2 scan, timed from outside: the program's
``models.ssm._ssd_scan`` at the step's shapes (head inputs, B and C in
the compute dtype, steps and decays in f32), forward and forward with
backward between CUDA events, times the Mamba-2 layers (under remat its
forward runs twice)."""

from __future__ import annotations

import math

import torch

from perfbench import flops
from perfbench.profiling import cuda_ms


def measure(ctx) -> dict:
    from repro_torch.models import ssm

    cfg, B, S, dev = ctx.cfg, ctx.batch, ctx.seq, ctx.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dt_c = getattr(torch, cfg["compute_dtype"])
    H, N = cfg["ssm_heads"], cfg["ssm_state"]
    P = cfg["d_inner"] // H
    x = torch.randn((B, S, H, P), generator=gen, device=dev, dtype=dt_c).requires_grad_(True)
    Bm, Cm = (torch.randn((B, S, N), generator=gen, device=dev, dtype=dt_c).requires_grad_(True)
              for _ in range(2))
    step = (torch.rand((B, S, H), generator=gen, device=dev) * (0.1 - 1e-3) + 1e-3)
    step.requires_grad_(True)
    A = (-torch.exp(torch.rand((H,), generator=gen, device=dev) * math.log(16.0)))
    A.requires_grad_(True)
    h0 = torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)
    gy = torch.randn((B, S, H, P), generator=gen, device=dev)

    def fwd():
        return ssm._ssd_scan(x, step, A, Bm, Cm, h0)[0]

    def fwd_bwd():
        torch.autograd.grad(fwd(), (x, step, A, Bm, Cm), gy)

    with torch.no_grad():
        f_ms = cuda_ms(fwd)
    fb_ms = cuda_ms(fwd_bwd)
    apps = ctx.family.applications(cfg)["ssd"]
    again = cfg["probes"]["ssd"]["recomputed"]
    return {"forward_ms": f_ms, "forward_backward_ms": fb_ms, "applications": apps,
            "step_ms": apps * (fb_ms + (f_ms if again else 0.0)),
            "model_flops": 3.0 * apps * flops.ssd_forward_flops(cfg, B, S)}
