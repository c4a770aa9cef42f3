"""Per-tensor fake-quantization: the CUDA kernel ``csrc/fake_quant.cu`` and
its plain PyTorch version.

``fake_quant_2d`` replaces the TPU kernel ``fake_quant_2d``
(``src/repro/kernels/quantize.py:42``) behind ``ops.fake_quant``: with a
given per-tensor scale s and ``qmax = 2**(bits-1) - 1``,

    out = clip(round(x / s), -qmax, qmax) * s              (round half to even)
    out = clip(floor(x / s) + (u < x / s - floor(x / s)), -qmax, qmax) * s

the second with a given noise array u of uniforms in [0, 1) (stochastic
rounding), all in f32 and each op correctly rounded, the result rounded to
x's dtype (float32 or bfloat16). Where the TPU kernel wants a (rows, 128k)
tensor with rows a multiple of 256, both versions here take x of any shape
and length. Kernel and plain version agree bit for bit.

Dispatch: a tensor on the CPU runs the plain version; a CUDA tensor
launches the kernel or raises. The kernel is memory-bound.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import qrange
from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fake_quant_plain(
    x: torch.Tensor, scale: torch.Tensor, bits: int, noise: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same ops in the same order.
    The scale is a 0-d f32 tensor on x's device, so the division is a
    correctly rounded f32 division on either device."""
    qmax = float(qrange(bits))
    s = scale.to(device=x.device, dtype=torch.float32).reshape(())
    scaled = x.to(torch.float32) / s
    if noise is None:
        q = torch.round(scaled)
    else:
        fl = torch.floor(scaled)
        q = fl + (noise.to(torch.float32) < (scaled - fl)).to(torch.float32)
    q = torch.clamp(q, -qmax, qmax)
    return (q * s).to(x.dtype)


def fake_quant_2d(
    x: torch.Tensor, scale: torch.Tensor, bits: int, noise: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Fake-quantize x (any shape, float32 or bfloat16) with the per-tensor
    ``scale`` (one f32 value) at ``bits``; ``noise`` (x's shape, f32
    uniforms in [0, 1)) selects stochastic rounding. Returns x's dtype."""
    if not _build.on_card(x):
        return fake_quant_plain(x, scale, bits, noise)
    idx = x.get_device()
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.numel() < 1 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous and non-empty, got {tuple(x.shape)}")
    if scale.numel() != 1 or scale.get_device() != idx:
        raise ValueError(f"scale must be one value on {x.device}, got {tuple(scale.shape)} on "
                         f"{scale.device}")
    if scale.dtype is not torch.float32:
        scale = scale.to(torch.float32)
    out = torch.empty_like(x)
    xp, op = x.data_ptr(), out.data_ptr()
    ptrs = xp | op
    if noise is not None:
        if (noise.shape != x.shape or noise.dtype is not torch.float32
                or noise.get_device() != idx):
            raise ValueError(f"noise must be float32 of shape {tuple(x.shape)} on {x.device}")
        if not noise.is_contiguous():
            raise ValueError("noise must be contiguous")
        ptrs |= noise.data_ptr()
    _build.launch(_build.library("fake_quant").fake_quant_launch, idx,
                  xp, code, x.numel(), scale.data_ptr(),
                  None if noise is None else noise.data_ptr(), float(qrange(bits)), op,
                  int(ptrs % 16 == 0))
    fake_quant_2d.launches += 1
    return out


# launches of the kernel wrapper (plain-version calls do not count)
fake_quant_2d.launches = 0
