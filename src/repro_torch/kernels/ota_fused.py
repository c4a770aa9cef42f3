"""The OTA data-plane kernels and their plain PyTorch versions.

Packed superpose / fold (``csrc/ota_superpose.cu``): ``ota_superpose`` replaces the TPU kernel ``ota_packed_2d`` and
``ota_fold`` replaces ``ota_fold_2d`` (the JAX package's
``kernels/ota_fused.py``). Both compute, per output column m,

    y[m] = [acc[m] +] sum_k c_k * (s_k[m // qblock] * q_k[m]),
    c_k  = w_k [* g_k]

over one storage group's K_g rows: q (K_g, M) int8/int16/int32/f32
symbols, or (K_g, M/2) uint8 int4 nibbles with ``packed4``; scale
(K_g,)/(K_g, 1) per-row or the (K_g, n_blocks) blockwise matrix. The sum
runs k = 0..K_g-1 in order, each op rounded on its own, so kernel and
plain version agree bit for bit and fold(zeros, b) == superpose(b).

In-pass quantize-superpose (``csrc/ota_quantize_superpose.cu``):
``ota_quantize_superpose`` replaces the TPU kernel ``ota_fused_2d``. It
stochastically quantizes each f32 row k against the dither
``sr_dither(seed, k, m)`` on the grid (s_k, qmax_k) (qmax_k == 0 passes
the row through), dequantizes, superposes with weights w_k in k order,
and returns the aggregate with its sum of squares. One launch takes at
most ``QS_MAX_K`` = 4,000 rows; a larger cohort runs as passes over
consecutive chunks of rows, each continuing the previous pass's aggregate
(``acc_in``) at its global row index (``k0``), so the result is the
one-pass result bit for bit at every K. Kernel and plain version agree bit
for bit on the aggregate; the sum of squares is summed in another order
(relative difference within 1e-5).

Dispatch: a tensor on the CPU runs the plain version; a CUDA tensor
launches the kernel or raises. The kernels are memory-bound (see the
sources' notes).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import sr_dither
from repro_torch.core.wire import unpack_int4_rows
from repro_torch.kernels import _build

_KIND_CODE = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.float32: 3}
_KIND_INT4 = 4


def _scale_matrix(scale: torch.Tensor, K: int) -> torch.Tensor:
    s = scale.to(torch.float32)
    return s.reshape(K, 1) if s.dim() <= 1 else s


def superpose_plain(
    q: torch.Tensor,
    scale: torch.Tensor,
    w: torch.Tensor,
    *,
    gains: Optional[torch.Tensor] = None,
    qblock: int = 0,
    packed4: bool = False,
    acc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same ops in the same order."""
    if packed4:
        q = unpack_int4_rows(q)
    K, M = q.shape
    scales = _scale_matrix(scale, K)
    nb = scales.shape[1]
    blockwise = qblock > 0 and nb > 1
    if blockwise:
        bid = (torch.arange(M, device=q.device) // qblock).clamp_max(nb - 1)
    c = w.to(torch.float32).reshape(K)
    if gains is not None:
        c = c * gains.to(torch.float32).reshape(K)
    part = torch.zeros(M, dtype=torch.float32, device=q.device)
    for k in range(K):
        s_k = scales[k, bid] if blockwise else scales[k, 0]
        part = part + (q[k].to(torch.float32) * s_k) * c[k]
    return part if acc is None else acc.to(torch.float32) + part


def _as_f32_vector(t: torch.Tensor, K: int) -> torch.Tensor:
    """t as K contiguous f32 values (itself where it already is one)."""
    if t.dtype is torch.float32 and t.is_contiguous() and t.numel() == K:
        return t
    return t.to(torch.float32).reshape(K)


def _launch(acc, q, scale, w, gains, qblock, packed4) -> torch.Tensor:
    idx = q.get_device()
    shape = q.shape
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"q must be (K, cols) with K, cols >= 1, got {tuple(shape)}")
    K, cols = shape
    if packed4:
        if q.dtype is not torch.uint8:
            raise TypeError(f"packed4 rows must be uint8, got {q.dtype}")
        kind, M = _KIND_INT4, 2 * cols
    else:
        kind = _KIND_CODE.get(q.dtype)
        if kind is None:
            raise TypeError(f"unsupported symbol dtype {q.dtype}")
        M = cols
    if scale.dim() <= 1 and scale.dtype is torch.float32 and scale.numel() == K:
        scales, nb = scale, 1  # per row: the (K, 1) matrix's memory as it is
    else:
        scales = _scale_matrix(scale, K)
        if scales.dim() != 2 or scales.shape[0] != K:
            raise ValueError(f"scale must be (K,) or (K, n_blocks), got {tuple(scale.shape)}")
        nb = scales.shape[1]
    if qblock <= 0 and nb != 1:
        raise ValueError("a blockwise scale matrix needs qblock > 0")
    wv = _as_f32_vector(w, K)
    gv = None if gains is None else _as_f32_vector(gains, K)
    if acc is not None and (acc.shape != (M,) or acc.dtype is not torch.float32):
        raise ValueError(f"acc must be ({M},) float32, got {tuple(acc.shape)} {acc.dtype}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("scale", scales), ("w", wv), ("gains", gv), ("acc", acc)):
        if t is None:
            continue
        if t.get_device() != idx:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty(M, dtype=torch.float32, device=q.device)
    row_bytes = cols * q.element_size()
    qp, op, ap = q.data_ptr(), out.data_ptr(), (None if acc is None else acc.data_ptr())
    _build.launch(_build.library("ota_superpose").ota_superpose_launch, idx,
                  qp, kind, K, M, row_bytes, scales.data_ptr(), nb, int(qblock), wv.data_ptr(),
                  None if gv is None else gv.data_ptr(), ap, op,
                  int((qp | row_bytes | op | (ap or 0)) % 16 == 0))
    return out


def ota_superpose(
    q: torch.Tensor,
    scale: torch.Tensor,
    w: torch.Tensor,
    *,
    gains: Optional[torch.Tensor] = None,
    qblock: int = 0,
    packed4: bool = False,
) -> torch.Tensor:
    """Dequant + weighted superpose of one storage group -> (M,) f32."""
    if not _build.on_card(q):
        return superpose_plain(q, scale, w, gains=gains, qblock=qblock, packed4=packed4)
    out = _launch(None, q, scale, w, gains, qblock, packed4)
    ota_superpose.launches += 1
    return out


def ota_fold(
    acc: torch.Tensor,
    q: torch.Tensor,
    scale: torch.Tensor,
    w: torch.Tensor,
    *,
    gains: Optional[torch.Tensor] = None,
    qblock: int = 0,
    packed4: bool = False,
) -> torch.Tensor:
    """acc + the group's superpose -> (M,) f32 (a new tensor)."""
    if not _build.on_card(q):
        return superpose_plain(
            q, scale, w, gains=gains, qblock=qblock, packed4=packed4, acc=acc
        )
    out = _launch(acc, q, scale, w, gains, qblock, packed4)
    ota_fold.launches += 1
    return out


def quantize_superpose_plain(
    x: torch.Tensor,
    scale: torch.Tensor,
    qmax: torch.Tensor,
    w: torch.Tensor,
    seed: int,
    *,
    acc_in: Optional[torch.Tensor] = None,
    k0: int = 0,
):
    """Plain PyTorch version of the in-pass quantize-superpose kernel: the
    same ops in the same order, row by row. Per-row operands are (1,)
    slices of device tensors (never CPU scalars), so every division is a
    correctly rounded f32 division. ``x`` holds rows k0 .. k0 + K - 1 of the
    cohort (the dither follows the global row) and the sum continues from
    ``acc_in`` (zeros when None), so one pass equals chunked passes bit for
    bit. Returns (acc (M,), sumsq ())."""
    K, M = x.shape
    x = x.to(torch.float32)
    s = scale.to(torch.float32).reshape(K)
    qm = qmax.to(torch.float32).reshape(K)
    wv = w.to(torch.float32).reshape(K)
    pos = torch.arange(M, dtype=torch.int64, device=x.device)
    acc = torch.zeros(M, dtype=torch.float32, device=x.device)
    if acc_in is not None:
        acc = acc_in.to(torch.float32).clone()
    for k in range(K):
        s_k, q_k = s[k : k + 1], qm[k : k + 1]
        u = sr_dither(seed, k0 + k, pos)
        sc = x[k] / s_k
        fl = torch.floor(sc)
        q = fl + (u < (sc - fl)).to(torch.float32)
        q = torch.minimum(torch.maximum(q, -q_k), q_k)
        dq = torch.where(q_k > 0, q * s_k, x[k])
        acc = acc + dq * wv[k : k + 1]
    return acc, (acc * acc).sum()


QS_MAX_K = 4000  # rows per launch (the CUDA source's MAX_K)
_QS_THREADS = 256  # as in the CUDA source
# the wide kernel (4 columns a thread) from this many columns on, the
# narrow one (2 columns a thread) under it: see the CUDA source's note
_QS_WIDE_M = 1 << 20


def _qs_launch(x, scale, qmax, w, seed, acc_in, k0, with_sumsq, wide=None):
    """One launch over K <= QS_MAX_K rows starting at global row k0 (and
    the sum of squares' second), by the wide kernel where ``wide`` says so
    (by default where M >= _QS_WIDE_M)."""
    K, M = x.shape
    idx = x.get_device()
    if wide is None:
        wide = M >= _QS_WIDE_M
    out = torch.empty(M, dtype=torch.float32, device=x.device)
    partials = sumsq = None
    n_blocks = -(-(-(-M // (4 if wide else 2))) // _QS_THREADS)
    if with_sumsq:
        partials = torch.empty(n_blocks, dtype=torch.float32, device=x.device)
        sumsq = torch.empty((), dtype=torch.float32, device=x.device)
    ptrs = x.data_ptr() | out.data_ptr() | (0 if acc_in is None else acc_in.data_ptr())
    _build.launch(
        _build.library("ota_quantize_superpose").ota_quantize_superpose_launch, idx,
        x.data_ptr(), K, M, k0, scale.data_ptr(), qmax.data_ptr(), w.data_ptr(),
        int(seed) & 0xFFFFFFFF, None if acc_in is None else acc_in.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(), n_blocks,
        None if sumsq is None else sumsq.data_ptr(),
        int(M % 4 == 0 and ptrs % 16 == 0), int(wide))
    ota_quantize_superpose.launches += 1
    return out, sumsq


def ota_quantize_superpose(
    x: torch.Tensor,
    scale: torch.Tensor,
    qmax: torch.Tensor,
    w: torch.Tensor,
    seed: int,
    *,
    wide: Optional[bool] = None,
):
    """In-pass SR quantize -> dequant -> weighted superpose of (K, M) f32
    rows -> (acc (M,) f32, sumsq () f32). ``scale``/``qmax``/``w``: (K,);
    ``seed``: the uint32 dither seed. On the card K > QS_MAX_K runs as one
    launch per chunk of QS_MAX_K rows, in row order; ``wide`` picks the
    kernel (by default from M; both give the same acc)."""
    if not _build.on_card(x):
        return quantize_superpose_plain(x, scale, qmax, w, seed)
    if x.dim() != 2 or x.dtype is not torch.float32:
        raise ValueError(f"x must be (K, M) float32, got {tuple(x.shape)} {x.dtype}")
    K, M = x.shape
    if K < 1 or M < 1:
        raise ValueError(f"x must have >= 1 row and >= 1 column, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous float32")
    idx = x.get_device()
    for name, t in (("scale", scale), ("qmax", qmax), ("w", w)):
        if t.get_device() != idx:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype is not torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.numel() != K:
            raise ValueError(f"{name} must hold {K} values, got {tuple(t.shape)}")
    if K <= QS_MAX_K:  # contiguous K-value tensors: their data pointers are the (K,) rows
        return _qs_launch(x, scale, qmax, w, seed, None, 0, True, wide)
    cols = [t.reshape(K) for t in (scale, qmax, w)]
    acc = sumsq = None
    for c0 in range(0, K, QS_MAX_K):
        c1 = min(c0 + QS_MAX_K, K)
        acc, sumsq = _qs_launch(x[c0:c1], *(t[c0:c1] for t in cols), seed, acc, c0, c1 == K,
                                wide)
    return acc, sumsq


# launches of each kernel wrapper (plain-version calls do not count)
ota_superpose.launches = 0
ota_fold.launches = 0
ota_quantize_superpose.launches = 0
