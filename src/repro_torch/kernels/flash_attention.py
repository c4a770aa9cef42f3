"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain PyTorch version.

``flash_mha(q, k, v, *, causal=True)`` replaces the TPU kernel
``flash_attention`` (``src/repro/kernels/flash_attention.py:87``) behind
``ops.flash_mha``: the attention forward with the running max ``m``, the
running denominator ``l`` and the output accumulator in f32, scores
``(q . k) * D**-0.5`` in f32, masked entries at -1e30 (not -inf), ``p``
rounded to the value dtype before the PV product and the output
``acc / max(l, 1e-30)`` in the query dtype. The causal mask is top-left:
query row i sees keys j <= i, both counted from 0, also when Sq != Sk (rows
at or past Sk see every key).

It takes the model's own layout, q (B, Sq, H, D) and k/v (B, Sk, KV, D),
and returns (B, Sq, H, D). Where the reference repeats the KV heads to H and
zero-pads Sq and Sk to multiples of 128, the kernel reads query head h's
keys and values from KV head ``h // (H // KV)`` and masks keys at or past Sk
itself. The two agree wherever the reference's padded keys are invisible to
every real query row: Sk a multiple of 128, or causal attention with
Sq <= Sk. Elsewhere (``Sk % 128`` with ``causal=False`` or ``Sq > Sk``) some
real row of the reference sees its zero-padded keys, so ``flash_mha``
raises ``ValueError`` there, as the reference's own precondition says.

The plain version follows the TPU kernel's arithmetic tile by tile: keys
in tiles of 128, every query row carries f32 ``m``/``l``/``acc`` across the
tiles in order, ``p`` is rounded to the value dtype before PV. With causal
masking the rows before a tile's first key are skipped for that tile; with
-1e30 masking such a row gets ``p = 0`` and ``corr = 1`` exactly, so
skipping changes no bit. The kernel uses the same 128-key tiles, so kernel
and plain version differ only by summation order inside a tile.

The kernel is built for D in ``HEAD_DIMS`` and bfloat16 or float32; the
wrapper zero-pads any other D <= 128 to the next of them (zero columns
change no score; the scale stays D**-0.5 of the true D) and slices the
output back. D > 128 and other dtypes raise on the card; the plain version
takes any D and dtype.

Two CUDA kernels share the source, one per route, fixed by the dtype and
the instantiated width alone (``kernel_design``; the C launcher's
``design()`` is the same table): bf16 at every width runs
``flash_fwd_hopper`` (128-row CTAs, TMA into 128-byte swizzled column
blocks of 64, the last part-filled with TMA's zeros where D is not a
multiple of 64, both products on wgmma); float32 runs ``flash_fwd_f32``. A
route is not a fallback: a kernel that fails to build or launch raises.

Dispatch: CPU tensors run the plain version; CUDA tensors launch the
kernel or raise. The kernel has no backward: training keeps
``models/layers.chunked_attention``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

BK = 128  # keys per tile (the TPU kernel's BK)
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 80, 96, 112, 128)  # the kernel's instantiated widths
_DTYPE_CODE = {torch.bfloat16: 1, torch.float32: 0}
# the kernels by the code csrc/flash_attention.cu's design() gives them
DESIGNS = ("flash_fwd_f32", "flash_fwd_hopper")


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: attention of q (B, Sq, H, D) over
    k/v (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D**-0.5
    qf = q.permute(0, 2, 1, 3).reshape(B, KV, G, Sq, D).to(torch.float32)
    kf = k.permute(0, 2, 1, 3).to(torch.float32)  # (B, KV, Sk, D)
    vt = v.permute(0, 2, 1, 3)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32, device=q.device)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    for k0 in range(0, Sk, BK):
        k1 = min(k0 + BK, Sk)
        # causal: rows before k0 see none of this tile (skipped, bit-identical)
        r0 = k0 if causal else 0
        if r0 >= Sq:
            break
        qs = qf[:, :, :, r0:]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qs, kf[:, :, k0:k1]) * scale
        if causal:
            mask = qpos[r0:, None] >= kpos[None, k0:k1]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_prev = m[..., r0:]
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_prev - m_new)
        l[..., r0:] = l[..., r0:] * corr + p.sum(dim=-1)
        pv = torch.einsum(
            "bkgqc,bkcd->bkgqd", p.to(v.dtype).to(torch.float32),
            vt[:, :, k0:k1].to(torch.float32),
        )
        acc[..., r0:, :] = acc[..., r0:, :] * corr[..., None] + pv
        m[..., r0:] = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, Sq, D).permute(0, 2, 1, 3).contiguous().to(q.dtype)


def ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Spacing of ``dtype``'s values at each |x| (f32 tensor); below the
    smallest normal, the spacing there."""
    a = torch.clamp(x.float().abs(), min=torch.finfo(dtype).tiny)
    _, e = torch.frexp(a)  # a = m 2**e, m in [0.5, 1)
    return torch.finfo(dtype).eps * torch.exp2((e - 1).float())


# Tolerance of the kernel against flash_attention_plain, element by element:
# |out - plain| <= TOL_ULPS ulps of dtype at |plain|, plus TOL_ATOL[dtype];
# and at most TOL_SHARE[dtype] of the elements may differ at all.
#
# The two differ only in f32 summation order inside a tile. That moves the
# output's own rounding by an ulp, or moves one p across a bf16 rounding
# boundary: then the row's output moves by ulp(p) |v| / l, which for an
# output near zero (a cancelling sum) is many of its own ulps but small in
# absolute terms; the absolute term covers that. On an H100 at the serve
# shapes (``scripts/flash_tolerance_probe.py``) the sound kernel's largest
# excess over 2 ulps was 7.3e-4 (bf16) and 2.4e-7 (f32), and at most 0.38%
# of the bf16 elements differed. Planted faults in the same readings: a
# dropped key tile, an unrescaled tile or a mask one key ahead go beyond 2
# ulps by 0.2-4.5; in bf16, p left in f32 before PV or the scale rounded to
# bf16 go beyond by 2.4e-3-4.9e-3 and change 26-40% of the elements; in
# f32 the bf16 scale goes beyond by 2.3e-4. In f32 the summation order
# changes the last bits of about half the elements, so no share is bounded
# there.
TOL_ULPS = 2.0
TOL_ATOL = {torch.bfloat16: 2.0**-9, torch.float32: 1e-6}
TOL_SHARE = {torch.bfloat16: 0.01, torch.float32: 1.0}


def mismatch(out: torch.Tensor, plain: torch.Tensor) -> dict:
    """The kernel's output against the plain version's under the tolerance
    above: max_abs_err, the largest difference in ulps of |plain|, the share
    of elements that differ, the count beyond the element bound, and
    ``within``."""
    dtype = plain.dtype
    o, p = out.float(), plain.float()
    d = (o - p).abs()
    u = ulp(p, dtype)
    share = float((d > 0).float().mean())
    over = int((d > TOL_ULPS * u + TOL_ATOL[dtype]).sum())
    return {"max_abs_err": float(d.max()), "max_ulps": float((d / u).max()),
            "share_differing": share, "over_element_bound": over,
            "within": over == 0 and share <= TOL_SHARE[dtype] and bool(torch.isfinite(o).all())}


def _check(q, k, v, causal: bool) -> None:
    """Shapes, and the reference's padding precondition: on every device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, D)")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "do not match (equal batch and head dim; k == v)")
    if KV < 1 or H % KV:
        raise ValueError(f"{KV} KV heads do not divide {H} query heads")
    if B * Sq * H * D < 1 or Sk < 1:
        raise ValueError("empty attention")
    if Sk % BK and (not causal or Sq > Sk):
        raise ValueError(
            f"Sk = {Sk} is not a multiple of {BK}: the reference pads the keys to its tile "
            f"and, {'without the causal mask' if not causal else f'with Sq = {Sq} > Sk'}, "
            "real query rows would see the zero-padded keys. Non-causal callers, and causal "
            f"callers with Sq > Sk, must pass a tile-aligned Sk (a multiple of {BK})")


def _check_card(q, k, v) -> None:
    """What the kernel takes beyond the shapes."""
    D = q.shape[3]
    if D > HEAD_DIMS[-1]:
        raise ValueError(f"head dim {D} is not supported on the card (the kernel takes "
                         f"D <= {HEAD_DIMS[-1]})")
    if q.dtype not in _DTYPE_CODE or k.dtype is not q.dtype or v.dtype is not q.dtype:
        raise ValueError(f"q, k, v must share one dtype of bfloat16/float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    idx = q.get_device()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.get_device() != idx:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def kernel_head_dim(D: int) -> int:
    """The instantiated width a head of width D runs at (zero-padded)."""
    return next(d for d in HEAD_DIMS if d >= D)


def kernel_design(dtype: torch.dtype, D: int) -> str:
    """The kernel a card call of this dtype and head width launches (D
    zero-padded to ``kernel_head_dim`` first): every bf16 width runs
    ``flash_fwd_hopper``, every float32 width ``flash_fwd_f32``."""
    if dtype not in _DTYPE_CODE or not 1 <= D <= HEAD_DIMS[-1]:
        raise ValueError(f"no flash kernel for {dtype} at head dim {D}")
    return DESIGNS[0] if dtype == torch.float32 else DESIGNS[1]


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    _check_card(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dk = kernel_head_dim(D)
    if Dk != D:  # zero columns change no score; the scale stays D**-0.5
        q, k, v = (torch.nn.functional.pad(t, (0, Dk - D)) for t in (q, k, v))
    out = torch.empty_like(q)
    _build.launch(_build.library("flash_attention").flash_attention_launch, q.get_device(),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Sq, Sk, H, KV, Dk, _DTYPE_CODE[q.dtype], int(causal), D**-0.5)
    return out if Dk == D else out[..., :D].contiguous()


def flash_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Multi-head attention, q (B, Sq, H, D), k/v (B, Sk, KV, D), GQA when
    KV < H -> (B, Sq, H, D); ``causal`` masks top-left (row i sees keys
    j <= i). Sk must be a multiple of 128 unless ``causal`` and Sq <= Sk
    (the reference's padding precondition; ValueError otherwise)."""
    _check(q, k, v, causal)
    if not _build.on_card(q):
        return flash_attention_plain(q, k, v, causal=causal)
    out = _launch(q, k, v, causal)
    flash_mha.launches += 1
    return out


# launches of the kernel wrapper (plain-version calls do not count)
flash_mha.launches = 0
