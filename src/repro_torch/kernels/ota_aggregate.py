"""Weighted superposition of client rows plus receiver noise: the CUDA
kernel ``csrc/ota_aggregate.cu`` and its plain PyTorch version.

``ota_aggregate_2d`` replaces the TPU kernel ``ota_aggregate_2d``
(``src/repro/kernels/ota_aggregate.py:32``) behind ``ops.ota_aggregate``:

    y[m] = sum_k w_k * x[k, m] + noise_std * noise[m]

for x (K, M) f32, w (K,), noise (M,) and the scalar noise_std. The sum runs
k = 0..K-1 in order from zero, each product and sum rounded on its own, and
the noise term is added last, so kernel and plain version agree bit for
bit. The TPU kernel reduces its VMEM block with ``jnp.sum`` in an order
XLA chooses: against it the port agrees within f32 summation error.

Dispatch: a tensor on the CPU runs the plain version; a CUDA tensor
launches the kernel or raises. The kernel is memory-bound.
"""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels import _build


def _operands(x, w, noise, noise_std):
    """w as (K,) f32 and noise_std as a 0-d f32 tensor on x's device (a
    Python float rounded to f32 on the way)."""
    wv = w.to(device=x.device, dtype=torch.float32).reshape(x.shape[0])
    std = torch.as_tensor(noise_std, dtype=torch.float32).to(x.device).reshape(())
    return wv, noise.to(torch.float32), std


def ota_aggregate_plain(
    x: torch.Tensor, w: torch.Tensor, noise: torch.Tensor,
    noise_std: Union[float, torch.Tensor],
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same ops in the same order."""
    wv, nz, std = _operands(x, w, noise, noise_std)
    x = x.to(torch.float32)
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for k in range(x.shape[0]):
        acc = acc + x[k] * wv[k : k + 1]
    return acc + std * nz


def ota_aggregate_2d(
    x: torch.Tensor, w: torch.Tensor, noise: torch.Tensor,
    noise_std: Union[float, torch.Tensor],
) -> torch.Tensor:
    """Superpose K client rows: x (K, M) f32, w (K,), noise (M,) f32,
    noise_std a float or a one-value tensor -> (M,) f32."""
    if not _build.on_card(x):
        return ota_aggregate_plain(x, w, noise, noise_std)
    idx = x.get_device()
    if x.dim() != 2 or x.dtype is not torch.float32 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (K, M) float32 with K, M >= 1, got {tuple(x.shape)} "
                         f"{x.dtype}")
    K, M = x.shape
    if w.numel() != K:
        raise ValueError(f"w must hold {K} values, got {tuple(w.shape)}")
    if noise.shape != (M,) or noise.dtype is not torch.float32:
        raise ValueError(f"noise must be ({M},) float32, got {tuple(noise.shape)} {noise.dtype}")
    for name, t in (("w", w), ("noise", noise)):
        if t.get_device() != idx:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not (x.is_contiguous() and noise.is_contiguous()):
        raise ValueError("x and noise must be contiguous")
    if w.dtype is not torch.float32 or not w.is_contiguous():
        w = w.to(torch.float32).contiguous()
    std = None  # a Python number goes by value, rounded to f32 by ctypes
    if isinstance(noise_std, torch.Tensor):
        std = noise_std.to(device=x.device, dtype=torch.float32).reshape(())
    out = torch.empty(M, dtype=torch.float32, device=x.device)
    aligned = M % 4 == 0 and (x.data_ptr() | noise.data_ptr() | out.data_ptr()) % 16 == 0
    _build.launch(_build.library("ota_aggregate").ota_aggregate_launch, idx,
                  x.data_ptr(), K, M, w.data_ptr(), noise.data_ptr(),
                  None if std is None else std.data_ptr(),
                  0.0 if std is not None else float(noise_std), out.data_ptr(), int(aligned))
    ota_aggregate_2d.launches += 1
    return out


# launches of the kernel wrapper (plain-version calls do not count)
ota_aggregate_2d.launches = 0
