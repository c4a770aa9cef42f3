"""The kernel entry points of the port, with the names and semantics of the
JAX package's ``kernels/ops.py``.

Where the reference pads and reshapes to its TPU tiles, the kernels here
take any shape, so the entry points only compute what the reference
computes outside its kernels (the fake-quant scale, the weight quantizer,
the int4 pack) and call the kernel wrappers: ``kernels/quantize.py``
(fake-quant), ``kernels/ota_aggregate.py``, ``kernels/qmatmul.py``,
``kernels/ota_fused.py`` (in-pass quantize-superpose, packed superpose and
fold), ``kernels/topk_similarity.py`` (cosine top-k;
``topk_cosine_sharded`` splits it over a ``launch.mesh.DataMesh``) and
``kernels/flash_attention.py`` (``flash_mha(q, k, v, *, causal=True)``,
causal or not, Sq != Sk, with the reference's precondition that Sk is a
multiple of 128 unless causal with Sq <= Sk). The row-major int4 wire pack
is ``core/wire.py``'s. On a CUDA tensor each entry point launches its
kernel; on a CPU tensor it runs its plain version.

Parity with the reference: ``fake_quant`` is jitted there, so its scale
``max(amax, 1e-12) / qmax`` is a multiply by the f32 reciprocal of qmax
(``core.quant._recip``); ``quantize_weights`` runs eagerly there, so its
divisions are true f32 divisions, here by 0-d tensors on the weight's device
(never by CPU scalars, which PyTorch on CUDA turns into a multiply).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quant import _f32, _recip, qrange
from repro_torch.core.wire import pack_int4_rows, unpack_int4_rows
from repro_torch.kernels import ota_fused, topk_similarity
from repro_torch.kernels.flash_attention import flash_mha
from repro_torch.kernels.ota_aggregate import ota_aggregate_2d
from repro_torch.kernels.ota_fused import ota_quantize_superpose
from repro_torch.kernels.qmatmul import qmatmul
from repro_torch.kernels.quantize import fake_quant_2d

TOPK_LANES = 128  # the reference kernel's running top-k width: k <= TOPK_LANES


def fake_quant_scale(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The per-tensor scale of ``fake_quant``: max(amax, 1e-12) times the f32
    reciprocal of qmax, a 0-d f32 tensor on x's device."""
    amax = torch.amax(x.abs()).to(torch.float32)
    return torch.clamp_min(amax, 1e-12) * _recip(qrange(bits), x)


def fake_quant(
    x: torch.Tensor,
    bits: int,
    *,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Per-tensor fake-quant of a float32 or bfloat16 tensor of any shape
    through the kernel; returns x's dtype. With ``stochastic`` the rounding
    noise is ``torch.rand`` of x's shape from ``generator`` on x's device."""
    scale = fake_quant_scale(x, bits)
    noise = None
    if stochastic:
        noise = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    return fake_quant_2d(x.contiguous(), scale, bits, noise)


ota_aggregate = ota_aggregate_2d  # the reference's entry-point name


# the reference's names of the packed superpose and fold: the receiver half
# of the packed uplink, (q, scale, w, *, gains=None, qblock=0,
# packed4=False) -> (M,) f32, and acc + the same superpose
ota_dequant_superpose = ota_fused.ota_superpose
ota_fold_packed = ota_fused.ota_fold


def topk_cosine(
    qm: torch.Tensor,
    recs: torch.Tensor,
    scales: Optional[torch.Tensor],
    n,
    *,
    k: int,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched cosine top-k over an arena record slab: qm (Q, D) f32 unit
    queries; recs (Np, D) f32 or int8 with Np a multiple of 256; scales the
    int8 slab's (Np, D / qblock) grid or None; n the live record count ->
    (scores (Q, k) f32, idx (Q, k) int32) under the tie contract. k <=
    TOPK_LANES, as in the reference. ``use_kernel=False`` runs the plain
    version on any device."""
    assert 0 < k <= TOPK_LANES, k
    if not use_kernel:
        return topk_similarity.topk_plain(qm, recs, scales, int(n), k)
    return topk_similarity.topk_cosine(qm, recs, scales, int(n), k=k)


def topk_cosine_sharded(
    qm: torch.Tensor,
    recs,
    scales,
    n,
    *,
    k: int,
    mesh,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded ``topk_cosine`` over the ``data`` axis of ``mesh``
    (``launch.mesh.DataMesh``; the reference's ``topk_cosine_sharded``).

    ``recs``: the (Np, D) capacity slab, Np a multiple of shards x
    ``TILE_N``, or the shards' own (Np / shards, D) slabs, shard s on
    ``mesh.devices[s]`` (the engine keeps them so); ``scales`` alike (None
    for f32). Shard s scores its rows with its live count clip(n - s *
    rows, 0, rows) through the top-k kernel (``use_kernel=False``: its
    plain version) on its device (a shard past n launches with count 0 and
    returns -inf entries), and its indices are offset by s * rows. The
    candidates merge on ``devices[0]``: concatenated in shard order and
    sorted by ``topk_similarity.sort_key`` (score descending, ties by
    ascending global index). Each score is one record's ordered dot
    product and the shard bounds fall on tiles, so scores and indices are
    ``topk_cosine``'s bit for bit; any global top-k member is top-k in its
    shard, so k candidates a shard suffice. k <= TOPK_LANES.
    """
    devices = mesh.devices
    n_shards = len(devices)
    if isinstance(recs, torch.Tensor):
        Np = recs.shape[0]
        assert Np % (n_shards * topk_similarity.TILE_N) == 0, (Np, n_shards)
        rows = Np // n_shards
        rec_s = [recs[s * rows : (s + 1) * rows] for s in range(n_shards)]
        sc_s = [None if scales is None else scales[s * rows : (s + 1) * rows]
                for s in range(n_shards)]
    else:
        rec_s = list(recs)
        sc_s = [None] * n_shards if scales is None else list(scales)
        rows = rec_s[0].shape[0]
        assert len(rec_s) == len(sc_s) == n_shards, (len(rec_s), n_shards)
        assert rows % topk_similarity.TILE_N == 0 and all(r.shape[0] == rows for r in rec_s)
    assert 0 < k <= TOPK_LANES, k
    n = int(n)
    cand_s, cand_i = [], []
    for s, dev in enumerate(devices):
        n_local = min(max(n - s * rows, 0), rows)
        sc = None if sc_s[s] is None else sc_s[s].to(dev)
        if use_kernel:
            sv, iv = topk_similarity.topk_cosine(qm.to(dev), rec_s[s].to(dev), sc, n_local, k=k)
        else:
            sv, iv = topk_similarity.topk_plain(qm.to(dev), rec_s[s].to(dev), sc, n_local, k)
        cand_s.append(sv.to(devices[0]))
        cand_i.append((iv + s * rows).to(devices[0]))
    cs, ci = torch.cat(cand_s, dim=1), torch.cat(cand_i, dim=1)
    order = torch.argsort(topk_similarity.sort_key(cs, ci), dim=1, descending=True)[:, :k]
    return cs.gather(1, order), ci.gather(1, order)


def quantize_weights(w: torch.Tensor, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric quantization for qmatmul: (q int8 (K, N),
    scale (N,) f32). Round half to even, in w's dtype."""
    qmax = qrange(bits)
    amax = torch.amax(w.abs(), dim=0)
    scale = torch.clamp_min(amax, 1e-12) / _f32(float(qmax), w)
    q = torch.clamp(torch.round(w / scale[None, :]), -qmax, qmax).to(torch.int8)
    return q, scale.to(torch.float32)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """q: int8 values in [-8, 7] with an even first dim -> (K//2, N) uint8,
    rows 2i (low nibble) and 2i + 1 (high nibble) sharing a byte. (The
    uplink wire pairs adjacent elements of a row instead:
    ``core.wire.pack_int4_rows``.)"""
    if q.shape[0] % 2:
        raise ValueError("pack_int4 needs an even K dim")
    lo = (q[0::2] & 0x0F).to(torch.uint8)
    hi = (q[1::2] & 0x0F).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4 -> int8 in [-8, 7], shape (2*Kp, N)."""
    lo = (packed & 0x0F).to(torch.int8)
    hi = ((packed >> 4) & 0x0F).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)  # sign-extend the 4-bit values
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=1).reshape(2 * packed.shape[0], *packed.shape[1:])


def quantize_weights_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int4: returns (packed (K//2, N) uint8, scale)."""
    q, scale = quantize_weights(w, bits=4)
    return pack_int4(q), scale


def qmatmul_int4(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(int4-packed weights (K//2, N)): unpack, then the
    int8 kernel."""
    return qmatmul(x, unpack_int4(w_packed), scale)


__all__ = [
    "fake_quant", "fake_quant_scale", "flash_mha", "ota_aggregate", "ota_dequant_superpose",
    "ota_fold_packed", "ota_quantize_superpose", "pack_int4", "pack_int4_rows", "qmatmul",
    "qmatmul_int4", "quantize_weights", "quantize_weights_int4", "topk_cosine",
    "topk_cosine_sharded", "unpack_int4", "unpack_int4_rows",
]
