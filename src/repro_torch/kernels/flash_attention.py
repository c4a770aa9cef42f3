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
multiple of 64, both products on wgmma); float32 at every width runs
``flash_fwd_f32_hopper``, the same TMA-fed shape with both products on the
CUDA cores in the plain version's order (each score one fmaf chain over d,
each output's PV one chain over a tile's keys from zero, then acc * corr +
pv): the f32 tolerance below holds the kernel to the plain version's f32
rounding, which no tensor-core sum reproduces
(``scripts/flash_tolerance_probe.py`` models the six bf16 plane products
such a route would sum). A route is not a fallback: a kernel that fails to
build or launch raises.

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
DESIGNS = ("flash_fwd_f32_hopper", "flash_fwd_hopper")


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
# and at most max(TOL_SHARE[dtype] n, TOL_N0[dtype] D) of the n elements
# (head width D) may differ at all.
#
# bf16: the two differ in f32 summation order inside a tile and in the
# softmax's rounding (the kernel's exp2 with scale log2 e folded in, the
# plain version's exp). That moves the output's own rounding by an ulp, or
# moves one p across a bf16 rounding boundary: then the row's output moves
# by ulp(p) |v| / l, which for an output near zero (a cancelling sum) is
# many of its own ulps but small in absolute terms; the absolute term
# covers that. On an H100 (``scripts/flash_tolerance_probe.py``) the sound
# kernel's largest excess over 2 ulps was 9.8e-4 at every FLASH_CASES case
# and at most 0.67% of the elements differed (kimi-k2's 64 heads at 4,096;
# 7.3e-4 and 0.38% over the probe's first, fewer cases). Planted faults in
# the same readings: a dropped key tile, an unrescaled tile or a mask one
# key ahead go beyond 2 ulps by 0.16-4.7; p left in f32 before PV or the scale rounded to bf16 go
# beyond by 2.6e-4-6.2e-3 and change 37-65% of the elements.
#
# The share on small outputs (TOL_N0): one rounding flip of a p moves its
# whole row of D outputs, so on a few hundred elements 1% is two or three
# of them and cannot be resolved; the floor is a share of a row, TOL_N0 D
# elements (``small_floor``). The probe's part 3 read the card tests'
# outputs of at most 2,048 elements (one query row over 256 keys without
# the mask and over one causal key, 8 heads, every width; 1,000 seeds and
# the tests' own draws): the sound kernel differed in at most 13 / 18 / 30
# / 39 / 41 / 55 elements at D 32 / 64 / 80 / 96 / 112 / 128, the planted
# faults (p left in f32, the scale rounded to bf16, a dropped key tile) in
# at least 35 / 163 / 107 / 113 / 283 / 163 wherever they change anything
# (p in f32 and the bf16 scale change nothing over one key, nor the scale
# at D 64, where D**-0.5 is a bf16). TOL_N0 = 5/8 puts the floor (20 / 40
# / 50 / 60 / 70 / 80) between the two at every width, 1.45-2.2x above the
# sound kernel's largest and 1.75-4x under the nearest fault: no draw of
# the sound kernel beyond it, every fault beyond it at every draw. (200
# seeds of an earlier run read the sound kernel at most 10-27, the faults
# at least 35-304; a flat floor of 8 let 32 of 2,400 sound draws fail.)
# The kernel with the plain version's rounding (expf(s scale - m)) differs
# as much (at most 55) and costs 16% at the serve layer, so the rounding
# stays. Over 8 D / 0.01 elements the 1% share governs as before.
#
# f32: the plain version's own f32 rounding is of the absolute term's size
# (1e-6 where a few keys dominate a row), so the kernel sums both products
# in its order on the CUDA cores (csrc/flash_attention.cu). At every f32
# FLASH_CASES case its largest excess over 2 ulps was 1.2e-7 (Qwen3-8B's
# and StableLM-1.6B's serving shapes in f32 included), against planted
# faults of f32 on the tensor cores' bf16 plane products (a plain model,
# scripts/flash_tolerance_probe.split3_attention): PV as one bf16 pass
# 1.0e-2-2.5e-2, the (mid, mid) pair dropped 1.5e-5-4.4e-5, p not split
# 1.9e-3-4.5e-3; the scale rounded to bf16 2.2e-4-3.9e-4 (none at D 64);
# and the exact result
# (f64) 1.55e-6 beyond at Qwen3-8B's shape (18 elements), scores as the six
# plane products 1.79e-6 (43 elements). The summation order changes the
# last bits of a quarter of the elements, so no share is bounded there.
TOL_ULPS = 2.0
TOL_ATOL = {torch.bfloat16: 2.0**-9, torch.float32: 1e-6}
TOL_SHARE = {torch.bfloat16: 0.01, torch.float32: 1.0}
TOL_N0 = {torch.bfloat16: 0.625, torch.float32: 0.0}  # differing elements a head width


def small_floor(dtype: torch.dtype, D: int) -> int:
    """The share's floor on a small output at head width D: TOL_N0 D
    differing elements."""
    return int(TOL_N0[dtype] * D)


def mismatch(out: torch.Tensor, plain: torch.Tensor) -> dict:
    """The kernel's output against the plain version's under the tolerance
    above: max_abs_err, the largest difference in ulps of |plain|, the share
    and count of elements that differ, the count beyond the element bound,
    and ``within``."""
    dtype = plain.dtype
    o, p = out.float(), plain.float()
    d = (o - p).abs()
    u = ulp(p, dtype)
    differing = int((d > 0).sum())
    over = int((d > TOL_ULPS * u + TOL_ATOL[dtype]).sum())
    allowed = max(TOL_SHARE[dtype] * d.numel(), small_floor(dtype, plain.shape[-1]))
    return {"max_abs_err": float(d.max()), "max_ulps": float((d / u).max()),
            "share_differing": differing / d.numel(), "differing": differing,
            "over_element_bound": over,
            "within": over == 0 and differing <= allowed and bool(torch.isfinite(o).all())}


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
    ``flash_fwd_hopper``, every float32 width ``flash_fwd_f32_hopper``."""
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
