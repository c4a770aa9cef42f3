"""Batched cosine top-k: the CUDA kernel ``csrc/topk_cosine.cu`` and its
plain PyTorch version.

``topk_cosine`` replaces the TPU kernel ``topk_similarity_2d`` (the JAX
package's ``kernels/topk_similarity.py``): scores of (Q, D) unit queries
against an (Np, D) record slab — f32, or int8 dequantized with its
(Np, D / qblock) block scales — with positions >= n scoring -inf, and
each query's k best records under the tie contract (score descending,
equal scores by ascending record index).

Each score is the dot product accumulated over d = 0..D-1 in order, every
product and sum rounded on its own; the plain version does exactly that
and selects with a stable sort, so kernel and plain version return the
same scores and indices bit for bit. Entries past the live count are
-inf with ascending indices. The kernel selects by sorting one 64-bit key
per record (``sort_key`` states it here), in one launch.

Dispatch: CPU tensors run the plain version; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

TILE_N = 256  # records per CTA; the arena's capacity is a multiple
MAX_K = 256   # a chunk's list is at most its record count


def _dequant(recs: torch.Tensor, scales: Optional[torch.Tensor]) -> torch.Tensor:
    if scales is None:
        return recs.to(torch.float32)
    qblock = recs.shape[1] // scales.shape[1]
    return recs.to(torch.float32) * scales.to(torch.float32).repeat_interleave(qblock, dim=1)


def topk_plain(
    qm: torch.Tensor,
    recs: torch.Tensor,
    scales: Optional[torch.Tensor],
    n: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel -> (scores (Q, k), idx (Q, k))."""
    rec = _dequant(recs, scales)
    qf = qm.to(torch.float32)
    Np, D = rec.shape
    s = torch.zeros(qf.shape[0], Np, dtype=torch.float32, device=qf.device)
    for d in range(D):
        s = s + qf[:, d : d + 1] * rec[:, d]
    pos = torch.arange(Np, device=qf.device)
    s = torch.where(pos < int(n), s, torch.full_like(s, float("-inf")))
    vals, order = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), order[:, :k].to(torch.int32).contiguous()


def sort_key(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's selection key (``csrc/topk_cosine.cu``, ``make_key``) as
    a signed int64: descending key order is the tie contract (score
    descending, equal scores by ascending index), -0.0 tying +0.0.

    The high word holds the score's order-preserving bits (its int32 bit
    pattern where the score is >= +0, that pattern with every bit but the
    sign flipped where it is < 0), the low word ~index. The kernel's key is
    this one as an unsigned 64-bit integer plus 2^63 (its high word's top
    bit set for scores >= +0): both orders agree."""
    s = torch.where(scores == 0, torch.zeros_like(scores), scores.to(torch.float32))
    bits = s.view(torch.int32).to(torch.int64)
    hi = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return hi * (1 << 32) + (~idx.to(torch.int64) & 0xFFFFFFFF)


def _launch(qm, recs, scales, n, k):
    idx = qm.get_device()
    if qm.dim() != 2 or recs.dim() != 2 or qm.shape[1] != recs.shape[1]:
        raise ValueError(f"shapes {tuple(qm.shape)} x {tuple(recs.shape)} do not match")
    Q, D = qm.shape
    Np = recs.shape[0]
    if qm.dtype is not torch.float32:
        raise TypeError(f"queries must be float32, got {qm.dtype}")
    if Np % TILE_N or Np == 0:
        raise ValueError(f"slab rows {Np} must be a positive multiple of {TILE_N}")
    if not 1 <= k <= MAX_K or Q < 1:
        raise ValueError(f"need 1 <= k <= {MAX_K} and Q >= 1, got k={k}, Q={Q}")
    is_int8 = recs.dtype == torch.int8
    if is_int8:
        if scales is None or scales.dim() != 2 or scales.shape[0] != Np:
            raise ValueError("int8 records need an (Np, n_blocks) scale grid")
        if D % scales.shape[1]:
            raise ValueError(f"{scales.shape[1]} scale blocks do not divide D = {D}")
        if scales.dtype is not torch.float32:
            raise TypeError(f"scales must be float32, got {scales.dtype}")
    elif recs.dtype is not torch.float32:
        raise TypeError(f"records must be float32 or int8, got {recs.dtype}")
    for name, t in (("qm", qm), ("recs", recs), ("scales", scales if is_int8 else None)):
        if t is None:
            continue
        if t.get_device() != idx:
            raise ValueError(f"{name} is on {t.device}, queries on {qm.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # both outputs in one allocation: (Q, k) f32 scores, then (Q, k) int32
    # indices; the kernel needs no scratch
    out = torch.empty((2, Q, k), dtype=torch.int32, device=qm.device)
    out_s, out_i = out[0].view(torch.float32), out[1]
    _build.launch(_build.library("topk_cosine").topk_cosine_launch, idx,
                  qm.data_ptr(), Q, D, recs.data_ptr(), int(is_int8),
                  scales.data_ptr() if is_int8 else None,
                  scales.shape[1] if is_int8 else 1, Np, int(n), k,
                  out_s.data_ptr(), out_i.data_ptr())
    return out_s, out_i


def topk_cosine(
    qm: torch.Tensor,
    recs: torch.Tensor,
    scales: Optional[torch.Tensor],
    n: int,
    *,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) queries x (Np, D) slab -> (scores (Q, k) f32, idx (Q, k) int32)."""
    if not _build.on_card(qm):
        return topk_plain(qm, recs, scales, n, k)
    out = _launch(qm, recs, scales, n, k)
    topk_cosine.launches += 1
    return out


# launches of the kernel wrapper (plain-version calls do not count)
topk_cosine.launches = 0
