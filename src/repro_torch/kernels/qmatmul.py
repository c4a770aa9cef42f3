"""Weight-only int8 matrix product: the CUDA kernel ``csrc/qmatmul.cu`` and
its plain PyTorch version.

``qmatmul`` replaces the TPU kernel ``qmatmul`` (``src/repro/kernels/
qmatmul.py:42``) behind ``ops.qmatmul`` and ``ops.qmatmul_int4``:

    out = (x @ q) * scale                 x (M, K) f32/bf16, q (K, N) int8

with f32 accumulation and the per-output-channel scale (N,) applied to the
f32 sums, as the TPU kernel's epilogue does. The plain version is the
reference's oracle ``ref.qmatmul_ref``, ``x.float() @ (q.float() * scale)``:
the two differ by summation order and by where the scale is rounded in, so
they agree within the tolerance below, element by element. M, K and N may
be any size; the kernel masks the ragged edges itself.

Three CUDA kernels share the source, one per route, fixed by dtype, shape
and alignment alone (``kernel_design``; the C launcher's ``design()`` is
the same table): bf16 x with M > SMALL_M whose rows of x and w are whole
16-byte multiples (K % 8 == 0, N % 16 == 0) from 16-byte-aligned bases,
what TMA takes, runs ``qmm_hopper`` (wgmma on 256 x 128 tiles, each int8
weight tile converted to bf16 in shared memory); other bf16 x runs
``qmm_bf16`` (mma.sync; split k at M <= SMALL_M); float32 x runs
``qmm_f32``. A route is not a fallback: a kernel that fails to build,
encode its tensor maps or launch raises.

Dispatch: a tensor on the CPU runs the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BK = 32  # k_chunk granularity: a multiple of both kernels' k tile
SMALL_M = 16  # M at or below this takes the 16-row tiles (a decode step)
MAX_SPLITS = 32
BLOCKS_PER_SM = 4  # split k until about this many blocks per SM are in flight
# the kernels by the code csrc/qmatmul.cu's design() gives them
DESIGNS = ("f32", "bf16", "hopper")


def qmatmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x (M, K) @ dequant(w_q (K, N) int8, scale (N,))
    -> (M, N) f32, as the reference's oracle computes it."""
    w = w_q.to(torch.float32) * scale.to(device=w_q.device, dtype=torch.float32)[None, :]
    return x.to(torch.float32) @ w


# Tolerance of the kernel (and of the port on the CPU against the JAX
# kernel) against qmatmul_plain, element by element:
#
#   |out - plain| <= TOL_C * sqrt(K) * 2**-24 * (|x| @ |w_q * scale|)
#
# Both sum K products in f32 in different orders, and the plain version
# rounds each dequantized weight once more; unbiased rounding errors of a
# sum of K terms grow like sqrt(K) units of 2**-24 times the sum of the
# terms' magnitudes. On an H100 at Qwen3-8B's MLP widths
# (``scripts/qmatmul_tolerance_probe.py``) the sound kernel read at most
# 0.17 of these units (0.17 on the Hopper route too, whose wgmma sums each
# k16 step in its own order; ``chip_smoke.py`` read it at 0.20 at M =
# 1,000), and on the CPU the port against the JAX kernel at most 0.46 (K =
# 129). Planted faults in the same readings (two probe runs): x rounded to
# TF32 (f32 x) 1.5-7.5 at most, 1.1-3.4 at the 99th percentile; the output
# rounded to bf16 19-113; one weight row of K dropped 42-860; on the Hopper
# route one k16 step skipped 447-2,729 and the bf16 weight tile read
# unswizzled 14,136-45,912. The limit sits between 0.46 and 1.5, near the
# geometric middle of 0.46 and 1.9 (the first run's nearest fault).
TOL_C = 1.0


def error_units(out: torch.Tensor, plain: torch.Tensor, x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """|out - plain| per element in units of sqrt(K) 2**-24 (|x| @ |w_deq|)
    (0 where both are 0, inf where only the difference is nonzero)."""
    mag = x.to(torch.float32).abs() @ (
        w_q.to(torch.float32).abs() * scale.to(device=w_q.device, dtype=torch.float32)[None, :])
    unit = math.sqrt(x.shape[1]) * 2.0**-24 * mag
    d = (out.to(torch.float32) - plain.to(torch.float32)).abs()
    return torch.where(unit > 0, d / torch.where(unit > 0, unit, torch.ones_like(unit)),
                       torch.where(d > 0, torch.full_like(d, math.inf), torch.zeros_like(d)))


def mismatch(out: torch.Tensor, plain: torch.Tensor, x: torch.Tensor, w_q: torch.Tensor,
             scale: torch.Tensor) -> Dict[str, object]:
    """The kernel's output against the plain version's under the tolerance
    above: max_abs_err, the largest ``error_units`` (``max_ratio``), the
    count beyond TOL_C of them, and ``within``."""
    ratio = error_units(out, plain, x, w_q, scale)
    over = int((ratio > TOL_C).sum())
    return {"max_abs_err": float((out.to(torch.float32) - plain.to(torch.float32)).abs().max()),
            "max_ratio": float(ratio.max()), "over_element_bound": over,
            "within": over == 0 and bool(torch.isfinite(out).all())}


@functools.lru_cache(maxsize=256)
def split_k(M: int, N: int, K: int, bf16: bool, sms: int) -> Tuple[int, int]:
    """(splits, k_chunk): cut k into ranges of k_chunk (a multiple of BK)
    until the (m, n) tiles times the splits give about BLOCKS_PER_SM blocks
    an SM; at most MAX_SPLITS, and no range empty."""
    bm = 16 if M <= SMALL_M else 64
    bn = 128 if bf16 else 64
    tiles = -(-M // bm) * -(-N // bn)
    k_tiles = -(-K // BK)
    want = max(1, min(-(-BLOCKS_PER_SM * sms // tiles), k_tiles, MAX_SPLITS))
    k_chunk = -(-k_tiles // want) * BK
    return -(-K // k_chunk), k_chunk


def kernel_design(dtype: torch.dtype, M: int, N: int, K: int, x: torch.Tensor,
                  w_q: torch.Tensor) -> str:
    """The kernel a card call launches for x (M, K) of ``dtype`` and w_q
    (K, N): ``"hopper"`` where TMA can load both (bf16, M > SMALL_M, K % 8
    == 0, N % 16 == 0, both bases 16-byte aligned), else ``"bf16"`` or
    ``"f32"`` by dtype."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"no qmatmul kernel for x of {dtype}")
    if dtype == torch.float32:
        return DESIGNS[0]
    tma = K % 8 == 0 and N % 16 == 0 and x.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0
    return DESIGNS[2] if M > SMALL_M and tma else DESIGNS[1]


_SMS: Dict[int, int] = {}


def _sm_count(idx: int) -> int:
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def qmatmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) float32 or bfloat16 @ dequant(w_q (K, N) int8; per-channel
    scale (N,)) -> (M, N) float32."""
    if not _build.on_card(x):
        return qmatmul_plain(x, w_q, scale)
    idx = x.get_device()
    code = _DTYPE_CODE.get(x.dtype)
    if x.dim() != 2 or code is None:
        raise TypeError(f"x must be (M, K) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    if w_q.dim() != 2 or w_q.dtype is not torch.int8:
        raise TypeError(f"w_q must be (K, N) int8, got {tuple(w_q.shape)} {w_q.dtype}")
    M, K = x.shape
    K2, N = w_q.shape
    if K != K2 or min(M, K, N) < 1:
        raise ValueError(f"shapes x {tuple(x.shape)} and w_q {tuple(w_q.shape)} do not match")
    if scale.numel() != N:
        raise ValueError(f"scale must hold {N} values, got {tuple(scale.shape)}")
    for name, t in (("w_q", w_q), ("scale", scale)):
        if t.get_device() != idx:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not (x.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("x and w_q must be contiguous")
    if scale.dtype is not torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    if kernel_design(x.dtype, M, N, K, x, w_q) == "hopper":  # one pass over k, no split
        splits, k_chunk = 1, -(-K // BK) * BK
    else:
        splits, k_chunk = split_k(M, N, K, code == 1, _sm_count(idx))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    ws = torch.empty(splits * M * N, dtype=torch.float32, device=x.device) if splits > 1 else None
    _build.launch(_build.library("qmatmul").qmatmul_launch, idx,
                  x.data_ptr(), code, w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                  None if ws is None else ws.data_ptr(), M, N, K, splits, k_chunk)
    qmatmul.launches += 1
    return out


# launches of the kernel wrapper (plain-version calls do not count)
qmatmul.launches = 0
