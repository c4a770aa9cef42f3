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

Routes, fixed by dtype, M and w's alignment alone (``kernel_design``; the
C launcher's ``design()`` is the same table); "w TMA-loadable" is N % 16
== 0 and a 16-byte-aligned base:

- ``decode`` (``qmm_decode``): M <= SMALL_M, bf16 or f32 x of any
  alignment. One launch computes out^T = w^T x^T on wgmma (N on the 64-row
  side), k split across the CTAs of a thread-block cluster and summed
  through distributed shared memory in rank order (``cluster_split`` picks
  the cluster size); no scratch.
- ``hopper`` (``qmm_hopper``): bf16 x, M > SMALL_M: wgmma on 256 x 128
  tiles, each int8 weight tile converted to bf16 in shared memory. An x
  TMA cannot load (K % 8 != 0 or a base off 16-byte alignment) is first
  copied into scratch rows of 16-byte pitch.
- ``hopper_f32``: f32 x, M > SMALL_M: one pass writes x as three bf16
  planes (``split3_plain`` is its plain version) into scratch, and
  ``qmm_hopper`` multiplies each converted weight tile by the three planes
  into one f32 accumulator (128 x 128 tiles).
- ``decode_ldw``, ``hopper_ldw``, ``hopper_f32_ldw``: the same kernels
  where TMA cannot load w as tiles; their producers fetch w's rows
  themselves (boxes of a view of w whose row stride is 16 N) and realign
  them into the same shared-memory layout, so each output's summation
  order is the TMA route's.

f32 x reaches the tensor cores without losing f32 accuracy: x = hi + mid
+ lo exactly, each a bf16 (hi and mid truncations to 16 bits, lo the rest,
at most 8 significant bits), and each part times an int8 weight (exact in
bf16) is exact in f32, so the sum differs from the reference's f32 dot
only in summation order. No TF32. A route is not a fallback: a kernel that
fails to build, encode its tensor maps or launch raises.

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
SMALL_M = 16  # M at or below this is a decode step (the decode routes)
# the kernels by the code csrc/qmatmul.cu's design() gives them
DESIGNS = ("decode", "hopper", "hopper_f32", "decode_ldw", "hopper_ldw", "hopper_f32_ldw")
DECODE_BK = 64  # the decode route's k tile: its k_chunk is a multiple of it
DECODE_BN = 128  # columns of a decode CTA
MAX_CLUSTER = 8  # the portable thread-block cluster size


def qmatmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x (M, K) @ dequant(w_q (K, N) int8, scale (N,))
    -> (M, N) f32, as the reference's oracle computes it."""
    w = w_q.to(torch.float32) * scale.to(device=w_q.device, dtype=torch.float32)[None, :]
    return x.to(torch.float32) @ w


def split3_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 x -> (hi, mid, lo) bf16 with hi + mid + lo == x exactly, as the
    CUDA routes split it: hi is x's top 16 bits, mid the top 16 bits of r =
    x - hi (exact), lo = r - mid (at most 8 significant bits, exact in
    bf16). A non-finite x gives hi = x (a NaN stays a NaN) and mid = lo =
    0. Where lo falls below bf16's normal range (x under about 2**-110),
    bits of x under 2**-133 are dropped."""
    x = x.to(torch.float32)
    top = torch.tensor(-65536, dtype=torch.int32)  # 0xFFFF0000: a bf16's bits
    hi = x.view(torch.int32) & top
    r = torch.where(torch.isfinite(x), x - hi.view(torch.float32), torch.zeros_like(x))
    mid = r.view(torch.int32) & top
    lo = (r - mid.view(torch.float32)).view(torch.int32) & top
    hi = torch.where(torch.isnan(x), hi | 0x00400000, hi)  # the quiet bit keeps a NaN
    # each is a whole bf16 value: the casts round nothing
    return tuple(t.view(torch.float32).to(torch.bfloat16) for t in (hi, mid, lo))


def qmatmul_planes_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                         planes: Tuple[bool, bool, bool] = (True, True, True)) -> torch.Tensor:
    """The three-plane product in plain PyTorch: ((lo @ q + mid @ q) + hi @
    q) * scale in f32, the planes of ``split3_plain(x)`` (small first, as the
    kernels add them); ``planes`` leaves out the parts marked False."""
    q = w_q.to(torch.float32)
    acc = None
    for keep, part in reversed(list(zip(planes, split3_plain(x)))):
        if keep:
            y = part.to(torch.float32) @ q
            acc = y if acc is None else acc + y
    if acc is None:
        acc = torch.zeros((x.shape[0], q.shape[1]), dtype=torch.float32, device=x.device)
    return acc * scale.to(device=w_q.device, dtype=torch.float32)[None, :]


def one_hot_reference(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(x @ q) * scale rounded as the reference kernel rounds it, for an x
    with one nonzero a row: the dot (one product, exact in f64) rounded once
    to f32, then times the scale (exact in f64) rounded once. The plain
    version rounds q * scale first instead, so on such an x the two can
    differ by up to 3 ulps (each within 1.5 of the exact value)."""
    p = (x.to(torch.float64) @ w_q.to(torch.float64)).to(torch.float32)
    s = scale.to(device=w_q.device, dtype=torch.float64)[None, :]
    return (p.to(torch.float64) * s).to(torch.float32)


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in f32 units in the last place, element by element: the
    distance of the two values' places in the ordered f32 numbers (+0 and
    -0 the same place)."""
    def place(t):
        i = t.to(torch.float32).view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (place(a) - place(b)).abs()


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
# 0.17 of these units on the bf16 routes (the decode route 0.008, the
# Hopper route 0.17, whose wgmma sums each k16 step in its own order;
# ``chip_smoke.py`` read it at 0.20 at M = 1,000) and 0.54 on f32's Hopper
# route, whose three products a k16 step each round into the accumulator
# (the f32 decode route 0.04); on the CPU the port against the JAX kernel
# at most 0.46 (K = 129). Planted faults in the same readings: x rounded to
# TF32 (f32 x) 1.5-7.5 at most, 1.1-3.4 at the 99th percentile; the output
# rounded to bf16 18-113; one weight row of K dropped 37-860; on the Hopper
# routes one k16 step skipped 444-2,729 (on f32's, of the hi plane alone,
# 443-2,563) and the bf16 weight tile read unswizzled 14,136-45,912; on
# the decode route one cluster rank's partial dropped 2,895-20,150 and the
# int8 tile read unswizzled 10,450-36,150. The limit sits between 0.54 and
# 1.5, near the geometric middle of 0.46 and 1.9 (the first run's nearest
# fault). x without its lo plane reads 0.08-0.54, under the limit: a
# one-hot x (``one_hot_reference``, ``ulps``) catches it instead, at
# 213-494 ulps against the sound kernel's 1-2. The ``_ldw`` routes (their
# consumers, so each output's summation order, are the TMA routes') read
# 0.006-0.545 at Qwen3-8B's w_gate and w_down one byte off alignment, a
# ragged N and a partial last k tile (``--parts ldw``); planted faults of
# their producer: the realigning shift one byte off 10,730-53,850, the last
# column below N masked away 1,492-24,500 (its M elements); w's rows past
# K loaded and not zeroed changes no output bit (x is zero there) and is
# caught instead by ``scripts/qmatmul_bounds_check.py``, where its loads
# past w fault.
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
def cluster_split(N: int, K: int, sms: int) -> Tuple[int, int]:
    """(S, k_chunk) of the decode route: a cluster of S CTAs (1, 2, 4 or 8)
    a 128-column tile, rank r taking k_chunk (a multiple of DECODE_BK) from
    r k_chunk, no range empty. S is the fewest splits that give every SM a
    CTA: more, shorter CTAs only add each one's start and the cluster's
    reduction (Qwen3-8B's w_gate reads fastest at 2, its w_down at 8)."""
    tiles = -(-N // DECODE_BN)
    k_tiles = -(-K // DECODE_BK)

    def chunk(S):
        return -(-k_tiles // S) * DECODE_BK

    S = 1
    while S < MAX_CLUSTER and tiles * S < sms and (2 * S - 1) * chunk(2 * S) < K:
        S *= 2
    return S, chunk(S)


def kernel_design(dtype: torch.dtype, M: int, N: int, w_q: torch.Tensor) -> str:
    """The kernel a card call launches for x (M, K) of ``dtype`` and w_q
    (K, N): ``"decode"`` at M <= SMALL_M, else ``"hopper"`` for bfloat16
    and ``"hopper_f32"`` for float32; with ``"_ldw"`` where TMA cannot load
    w (N % 16 != 0 or a base off 16-byte alignment)."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"no qmatmul kernel for x of {dtype}")
    route = "decode" if M <= SMALL_M else "hopper" if dtype == torch.bfloat16 else "hopper_f32"
    return route if N % 16 == 0 and w_q.data_ptr() % 16 == 0 else route + "_ldw"


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
    ws = None
    if M <= SMALL_M:
        splits, k_chunk = cluster_split(N, K, _sm_count(idx))
    else:  # one pass over k; x through scratch rows of 16-byte pitch where TMA cannot load it
        splits, k_chunk = 1, K
        planes = 3 if code == 0 else 0 if K % 8 == 0 and x.data_ptr() % 16 == 0 else 1
        if planes:
            ws = torch.empty(planes * M * (-(-K // 8) * 8), dtype=torch.bfloat16,
                             device=x.device)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    _build.launch(_build.library("qmatmul").qmatmul_launch, idx,
                  x.data_ptr(), code, w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                  None if ws is None else ws.data_ptr(), M, N, K, splits, k_chunk)
    qmatmul.launches += 1
    return out


# launches of the kernel wrapper (plain-version calls do not count)
qmatmul.launches = 0
