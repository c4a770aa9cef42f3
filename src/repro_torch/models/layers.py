"""Initialisers and norms the DeepSpeech2 model uses (the JAX package's
``models/layers.py``)."""

from __future__ import annotations

from typing import Sequence

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(
    gen: torch.Generator,
    shape: Sequence[int],
    dtype: torch.dtype,
    device,
) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = fan_in**-0.5
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32) + bias.to(torch.float32)).to(dt)
