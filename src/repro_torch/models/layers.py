"""Neural layers of the port (the JAX package's ``models/layers.py``):
initialisers, norms, RoPE and sectioned M-RoPE, chunked attention, decode
attention, the attention block, the SwiGLU MLP and the MoE block (top-k
router, sort-based capacity dispatch into an (E, C, d) buffer, batched
expert products; under a mesh with a ``model`` axis, the reference's
expert-parallel path), and the attention and MLP blocks' tensor-parallel
branches (full-sequence and decode), which block leaves select
(``launch.steps``' sharded steps). Pure functions over param dicts.

Attention keeps the reference's layouts: q (B, S, H, D), k/v (B, S, KV, D),
GQA by grouping the H query heads over the KV heads. ``chunked_attention``
is the plain, flash-style path (online softmax over KV chunks); with
``cfg.use_flash_kernel`` causal prefill goes through the flash kernel
(``kernels/flash_attention.flash_mha``) instead.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs import ArchConfig
from repro_torch.kernels.flash_attention import flash_mha
from repro_torch.util import dtype_of, get_abstract_mesh  # noqa: F401  (the models read L.dtype_of)

Params = Dict[str, Any]

# ---------------------------------------------------------------- initialisers


# a leaf of more elements than this is drawn a slab at a time (a layer, then
# an expert, then a block of rows), so that the f32 draw beside a bf16 leaf
# of many GB stays at most 256 MB; smaller leaves are drawn whole
_SLAB = 1 << 26


def _slabs(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views that tile ``t`` in order, each of at most ``_SLAB`` elements
    (or one row of a wider 2-D leaf)."""
    if t.numel() <= _SLAB or t.dim() < 2:
        yield t
    elif t.dim() > 2:
        for sub in t.unbind(0):
            yield from _slabs(sub)
    else:
        rows = max(1, _SLAB // t.shape[1])
        for r in range(0, t.shape[0], rows):
            yield t[r:r + rows]


def _draw(shape: Sequence[int], dtype: torch.dtype, device, fill) -> torch.Tensor:
    """A leaf of ``shape`` and ``dtype`` whose slabs ``fill`` draws in f32,
    in order, and casts into place."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    if out.is_meta:  # shapes only (train_state_shapes, the dry run)
        return out
    for s in _slabs(out):
        if dtype == torch.float32:
            fill(s)
        else:
            w = torch.empty(s.shape, dtype=torch.float32, device=device)
            fill(w)
            s.copy_(w)
    return out


def dense_init(
    gen: torch.Generator,
    shape: Sequence[int],
    dtype: torch.dtype,
    device,
) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = fan_in**-0.5

    def fill(w):
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.mul_(std)

    return _draw(shape, dtype, device, fill)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               device) -> torch.Tensor:
    def fill(w):
        w.normal_(generator=gen).mul_(0.02)

    return _draw(shape, dtype, device, fill)


# ----------------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32) + bias.to(torch.float32)).to(dt)


# ------------------------------------------------------------------------ RoPE


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary halves (head_dim // 2,)."""
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta**expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard RoPE. x: (..., S, H, D); positions: (..., S) int."""
    if theta <= 0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, D // 2)
    return _rotate(x, angles)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the halves of x (..., S, H, D) by angles (..., S, D // 2)."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL sectioned M-RoPE. x: (B, S, H, D); positions: (B, 3, S),
    the temporal / height / width streams. ``sections`` partitions the
    rotary half-dim; section i rotates with stream i (sum == D // 2)."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to D // 2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    # the reference selects each frequency's stream by a one-hot product,
    # which picks the same f32 angle exactly
    pos = positions.to(torch.float32)
    angles, start = [], 0
    for i, n in enumerate(sections):
        angles.append(pos[:, i, :, None] * freqs[start:start + n])
        start += n
    return _rotate(x, torch.cat(angles, dim=-1))


# ----------------------------------------------------------- chunked attention

NEG_INF = -1e30


def _attn_chunk_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                     window: int) -> torch.Tensor:
    """(Qc, Kc) boolean mask: True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    k_chunk: int = 1024,
) -> torch.Tensor:
    """Memory-efficient attention with online softmax (flash-style), a
    Python loop over query and KV chunks.

    Never materialises more than (B, KV, G, Qc, Kc) scores. With causal
    block skip (causal, no window, Sq == Sk) query chunk i visits only KV
    chunks 0..i: the reference's unrolled and dynamic skip branches, which
    compute the same thing. Otherwise every query chunk visits every KV
    chunk under the mask (the masked full scan).
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    n_q = -(-Sq // q_chunk)
    n_k = -(-Sk // k_chunk)
    pad_q = n_q * q_chunk - Sq
    pad_k = n_k * k_chunk - Sk
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q)) if pad_q else q
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k)) if pad_k else k
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k)) if pad_k else v
    scale = D**-0.5
    dev = q.device
    q_pos_all = torch.arange(n_q * q_chunk, device=dev)
    k_pos_all = torch.arange(n_k * k_chunk, device=dev)
    skippable = causal and Sq == Sk and window == 0

    outs = []
    for qi in range(n_q):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        # (B, Qc, KV, G, D); scores in f32 (the reference's f32 accumulation)
        q_blk = qp[:, qs].reshape(B, q_chunk, KV, G, D).to(torch.float32)
        q_pos = q_pos_all[qs]
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        o = torch.zeros((B, KV, G, q_chunk, D), dtype=torch.float32, device=dev)
        for kj in range(qi + 1 if skippable else n_k):
            ks = slice(kj * k_chunk, (kj + 1) * k_chunk)
            k_blk, v_blk, k_pos = kp[:, ks], vp[:, ks], k_pos_all[ks]
            s = torch.einsum("bqkgd,bckd->bkgqc", q_blk, k_blk.to(torch.float32)) * scale
            mask = _attn_chunk_mask(q_pos, k_pos, causal, window)
            mask &= (k_pos < Sk)[None, :]  # key padding
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(v_blk.dtype).to(torch.float32),
                              v_blk.to(torch.float32))
            o = o * corr[..., None] + pv
            m = m_new
        outs.append((o / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
    out = torch.stack(outs)  # (n_q, B, KV, G, Qc, D)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, n_q * q_chunk, H, D)
    return out[:, :Sq]


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, W, KV, D)
    v_cache: torch.Tensor,  # (B, W, KV, D)
    cache_pos: torch.Tensor,  # (B, W) int, -1 = empty
    pos: torch.Tensor,  # (B,) current absolute position
    *,
    window: int = 0,
) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffer) KV cache."""
    B, W, KV, D = k_cache.shape
    H = q.shape[2]
    G = H // KV
    scale = D**-0.5
    qh = q.reshape(B, KV, G, D).to(torch.float32)
    s = torch.einsum("bkgd,bwkd->bkgw", qh, k_cache.to(torch.float32)) * scale
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    if window > 0:
        valid &= pos[:, None] - cache_pos < window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, 1, H, D).to(q.dtype)


# ------------------------------------------------------------- attention block


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device,
                   lead: Tuple[int, ...] = ()) -> Params:
    """One attention block's params; ``lead`` prepends axes (the stacked
    layer axis) to every leaf."""
    d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    Dh = cfg.resolved_head_dim()
    p: Params = {
        "wq": dense_init(gen, (*lead, d, H * Dh), dtype, device),
        "wk": dense_init(gen, (*lead, d, KV * Dh), dtype, device),
        "wv": dense_init(gen, (*lead, d, KV * Dh), dtype, device),
        "wo": dense_init(gen, (*lead, H * Dh, d), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, H * Dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros((*lead, KV * Dh), dtype=dtype, device=device)
        p["bv"] = torch.zeros((*lead, KV * Dh), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, Dh), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((*lead, Dh), dtype=dtype, device=device)
    return p


def _project_qkv(p: Params, x: torch.Tensor, cfg: ArchConfig):
    B, S, _ = x.shape
    H, KV = cfg.n_heads, cfg.n_kv_heads
    Dh = cfg.resolved_head_dim()
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KV, Dh)
    v = v.reshape(B, S, KV, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _position(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """RoPE, or M-RoPE for ``cfg.mrope``, on q and k."""
    if cfg.mrope:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)


def attention_block(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ArchConfig,
    positions: torch.Tensor,  # (B, S), or (B, 3, S) for mrope
    *,
    causal: bool = True,
    window: int = 0,
    differentiable: bool = True,
) -> Tuple[torch.Tensor, Tuple[Any, Any]]:
    """Full-sequence attention. Returns (out, (k, v)) for cache priming.

    Given block leaves (``wq`` and ``wo`` split over the model axis, see
    ``_attention_split``), the tensor-parallel branch; its (k, v) are
    lists of each model shard's k and v on its device."""
    if _is_split(p):
        return _attention_split(p, x, cfg, positions, causal, window, differentiable)
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _position(q, k, positions, cfg)
    out = _attend(q, k, v, cfg, causal, window, differentiable)
    B, S = q.shape[:2]
    out = out.reshape(B, S, -1) @ p["wo"]
    return out, (k, v)


def _is_split(p: Params) -> bool:
    """Whether the attention's leaves are block leaves (the tensor-parallel
    branch); half a split raises."""
    split = [n for n in ("wq", "wk", "wv", "wo") if not isinstance(p[n], torch.Tensor)]
    if split and ("wq" not in split or "wo" not in split):
        raise ValueError(f"only {split} of the attention are split over the model axis: "
                         "wq and wo split together")
    return bool(split)


def _attend(q, k, v, cfg: ArchConfig, causal: bool, window: int, differentiable: bool):
    """The flash kernel where it applies (forward-only: prefill and
    serving, causal, no window; it has no backward, so training keeps the
    chunked path), else ``chunked_attention``."""
    if cfg.use_flash_kernel and causal and window == 0 and differentiable is False:
        return flash_mha(q, k, v, causal=True)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_chunk=cfg.attn_chunk, k_chunk=cfg.attn_chunk)


def attention_decode_block(
    p: Params,
    x: torch.Tensor,  # (B, 1, d)
    cfg: ArchConfig,
    pos: torch.Tensor,  # (B,)
    cache: Dict[str, Any],
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step against a ring-buffer KV cache.

    cache = {"k": (B, W, KV, D), "v": (B, W, KV, D), "pos": (B, W) int32}.
    The new entries are written into the cache tensors in place (the
    reference returns updated copies); the same dict is returned. Given
    block leaves, the tensor-parallel branch (``_attention_decode_split``),
    whose cache entries are lists of each model shard's tensors."""
    if _is_split(p):
        return _attention_decode_split(p, x, cfg, pos, cache, window), cache
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _position(q, k, _decode_positions(pos, cfg), cfg)
    _write_slot(cache["k"], cache["v"], cache["pos"], k, v, pos)
    out = decode_attention(q, cache["k"], cache["v"], cache["pos"], pos, window=window)
    out = out.reshape(B, 1, -1) @ p["wo"]
    return out, cache


def _decode_positions(pos: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B, 1) positions of the token, (B, 3, 1) for M-RoPE."""
    positions = pos[:, None]
    if cfg.mrope:
        positions = positions[:, None, :].expand(pos.shape[0], 3, 1)
    return positions


def _write_slot(k_cache, v_cache, pos_cache, k, v, pos) -> None:
    """The token's k and v (B, 1, KV, D) into slot ``pos % W`` of each row,
    in place."""
    B = k.shape[0]
    slot = pos % k_cache.shape[1]
    bidx = torch.arange(B, device=k.device)
    k_cache[bidx, slot] = k[:, 0]
    v_cache[bidx, slot] = v[:, 0]
    pos_cache[bidx, slot] = pos.to(pos_cache.dtype)


# ------------------------------------------------------------------- MLP (SwiGLU)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype, device,
             lead: Tuple[int, ...] = ()) -> Params:
    return {
        "w_gate": dense_init(gen, (*lead, d_model, d_ff), dtype, device),
        "w_up": dense_init(gen, (*lead, d_model, d_ff), dtype, device),
        "w_down": dense_init(gen, (*lead, d_ff, d_model), dtype, device),
    }


def mlp_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU; given block leaves, the tensor-parallel branch
    (``_mlp_split``)."""
    if any(not isinstance(p[n], torch.Tensor) for n in ("w_gate", "w_up", "w_down")):
        return _mlp_split(p, x)
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ----------------------------------------------------------- tensor parallelism
#
# The reference's Megatron split over the mesh's ``model`` axis, as the
# sharded steps read it (``launch.steps``, ``tensor_parallel=True``):
# a block leaf holds model shard m's slice of a weight (``blocks[m]``, split
# on dim ``axis`` counted from the end) on the data row's m-th device. Model
# shard m runs its column blocks on a copy of the input on its device and
# multiplies by its row block, giving an f32 partial of the output; the
# partials are summed in f32 in shard order on the input's device (the
# row's first) and cast once to the activation dtype. Whole leaves (norms,
# biases, GQA's unsplit ``wk``/``wv``) sit on that device and are copied
# to each shard; autograd carries every copy's gradient back. A decode
# step's cache is one tensor a model shard, on its device: its kv heads,
# or every kv head where they do not divide the shards.


def _blocks(w, axis: int, devices, name: str) -> List[torch.Tensor]:
    """Model shard m's block of a block leaf split on ``axis``, which must
    sit on ``devices[m]``; anything else raises (no fallback)."""
    if (isinstance(w, torch.Tensor) or getattr(w, "axis", None) != axis or w.lead
            or [b.device for b in w.blocks] != list(devices)):
        raise ValueError(f"{name} is not a block leaf split on dim {axis} over {list(devices)}")
    return w.blocks


def _split_devices(w, home: torch.device, name: str) -> List[torch.device]:
    """The devices of a block leaf's model shards; the first must be
    ``home``, the input's device."""
    devices = [b.device for b in getattr(w, "blocks", ())]
    if not devices or devices[0] != home:
        raise ValueError(f"{name} is not a block leaf whose first block sits on {home}")
    return devices


def _whole(w, home: torch.device, name: str) -> torch.Tensor:
    if not isinstance(w, torch.Tensor) or w.device != home:
        raise ValueError(f"{name} must be a whole tensor on {home}")
    return w


@contextlib.contextmanager
def _tf32_if_exact(t: torch.Tensor):
    """TF32 products within where ``t`` is a CUDA tensor of a 16-bit float
    dtype: its values upcast to f32 (and a weight's of the same dtype) fit
    TF32's 10 mantissa bits exactly, so the f32 product reads them whole
    at the tensor cores' TF32 rate. (The package turns TF32 off at import,
    ``device.py``, through the same flag.)"""
    if not (t.is_cuda and t.dtype in (torch.bfloat16, torch.float16)):
        yield
        return
    flag = torch.backends.cuda.matmul
    old = flag.allow_tf32
    flag.allow_tf32 = True
    try:
        yield
    finally:
        flag.allow_tf32 = old


class _F32Product(torch.autograd.Function):
    """``a @ w`` with an f32 product whatever the inputs' float dtype: a
    row-parallel partial. The backward is autograd's product in the
    inputs' dtype: the gradient reaching a partial is the activation
    dtype's gradient of the sum upcast, which that dtype holds exactly."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        with _tf32_if_exact(a):
            return a.to(torch.float32) @ w.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ w.transpose(-2, -1) if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            gw = a.reshape(-1, a.shape[-1]).transpose(0, 1) @ g.reshape(-1, g.shape[-1])
        return ga, gw


class _RowSum(torch.autograd.Function):
    """The row-parallel sum as one node on ``home``: each model shard's
    partial brought to ``home`` and added in shard order, cast once to
    ``dtype``; the backward sends the gradient, in the partials' dtype,
    back to each shard's device.

    Under remat across distinct cards the backward's first node of a
    block must unpack a saved tensor on ``home``: the autograd engine runs
    each card's nodes in that card's own thread, and torch's non-reentrant
    checkpoint recomputes a block at the first unpack without a lock, so
    two shards' nodes unpacking at once would both recompute it. The
    empty tensor this node saves makes its own backward, which every
    shard's nodes wait for, that first unpack."""

    @staticmethod
    def forward(ctx, home, dtype, *partials):
        ctx.to = [(p.device, p.dtype) for p in partials]
        ctx.save_for_backward(torch.empty(0, device=home))
        return _sum_on(home, dtype, partials)

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors  # noqa: B018  (the unpack that runs remat's recompute here)
        return (None, None) + tuple(g.to(device=d, dtype=t) for d, t in ctx.to)


def _sum_on(home: torch.device, dtype, partials) -> torch.Tensor:
    acc = partials[0].to(home)
    for part in partials[1:]:
        acc = acc + part.to(home)
    return acc.to(dtype)


def _row_sum(partials: List[torch.Tensor], home: torch.device, dtype) -> torch.Tensor:
    """The row-parallel sum: each model shard's f32 partial brought to
    ``home`` and added in shard order, cast once to ``dtype``
    (``_RowSum``; without a gradient the same sum, no node)."""
    if not torch.is_grad_enabled():
        return _sum_on(home, dtype, partials)
    return _RowSum.apply(home, dtype, *partials)


def _cols(parts: List[torch.Tensor], lo: int, hi: int, device) -> torch.Tensor:
    """Columns [lo, hi) of the last dim of ``parts`` joined in order (each
    model shard's output of a column-parallel product, on its device), on
    ``device``: a view of the one part that holds them where it sits there,
    else the parts' slices copied and joined."""
    out, start = [], 0
    for t in parts:
        a, b = max(lo - start, 0), min(hi - start, t.shape[-1])
        if a < b:
            out.append(t[..., a:b].to(device))
        start += t.shape[-1]
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


def _kv_heads(k: torch.Tensor, m: int, Hl: int, G: int) -> torch.Tensor:
    """Of every kv head of k (B, S, KV, D), those model shard m's query
    heads [m Hl, (m + 1) Hl) read (head h reads h // G): a slice where the
    shard's heads make whole groups or lie in one group, else one kv head
    a query head."""
    heads = [h // G for h in range(m * Hl, (m + 1) * Hl)]
    if Hl % G == 0 or G % Hl == 0:
        return k[:, :, heads[0]:heads[-1] + 1]
    return k[:, :, heads]


def _attention_split(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                     causal: bool, window: int, differentiable: bool = True):
    """The attention block over M model shards (H / M query heads each):
    shard m projects x through its column blocks of ``wq`` (and of ``wk``
    and ``wv`` where the kv heads divide M; else through the whole leaves),
    adds its slice of the whole biases, applies the whole q/k norms and
    RoPE, keeps the kv heads its query heads read (``_kv_heads``), attends
    on its heads (``_attend``: the flash kernel under the whole path's
    gate, else ``chunked_attention``) and multiplies by its row block of
    ``wo``; ``_row_sum`` adds the f32 partials. Heads that do not divide M
    raise: a head is never split (the sharded step reads such a block
    whole). Returns (out, ([k], [v])): each shard's k and v for the cache,
    its KV / M kv heads, or every kv head (normed and rotated, before
    ``_kv_heads``) where the kv heads do not divide M."""
    B, S, d = x.shape
    home = x.device
    devices, Hl, G, wq, wo, wk, wv, kv_split, whole = _split_leaves(p, cfg, home)
    Dh = cfg.resolved_head_dim()
    partials, ks, vs = [], [], []
    with obs.span("tensor_parallel", kind="attn", mp=len(devices),
                  partial_bytes=len(devices) * B * S * d * 4):
        for m, dev in enumerate(devices):
            q, k, v = _project_shard(x.to(dev), m, Hl, wq, wk, wv, kv_split, whole, cfg)
            q, k = _position(q, k, positions.to(dev), cfg)
            ks.append(k)
            vs.append(v)
            if not kv_split:
                k, v = (_kv_heads(t, m, Hl, G).contiguous() for t in (k, v))
            o = _attend(q, k, v, cfg, causal, window, differentiable)
            partials.append(_F32Product.apply(o.reshape(B, S, Hl * Dh), wo[m]))
        return _row_sum(partials, home, x.dtype), (ks, vs)


def _split_leaves(p: Params, cfg: ArchConfig, home: torch.device):
    """The attention's block leaves over the model shards: (devices, Hl,
    G, wq, wo, wk, wv, kv_split, the whole biases and norms); a leaf the
    branch cannot take raises."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    devices = _split_devices(p["wq"], home, "wq")
    M = len(devices)
    if H % M:
        raise ValueError(f"{H} heads do not divide over {M} model shards")
    wq, wo = _blocks(p["wq"], -1, devices, "wq"), _blocks(p["wo"], -2, devices, "wo")
    kv_split = not isinstance(p["wk"], torch.Tensor)
    if kv_split:
        if KV % M:
            raise ValueError(f"{KV} kv heads do not divide over {M} model shards")
        wk, wv = (_blocks(p[n], -1, devices, n) for n in ("wk", "wv"))
    else:
        wk, wv = (_whole(p[n], home, n) for n in ("wk", "wv"))
    whole = {n: _whole(p[n], home, n) for n in ("bq", "bk", "bv", "q_norm", "k_norm") if n in p}
    return devices, H // M, H // KV, wq, wo, wk, wv, kv_split, whole


def _project_shard(xm, m: int, Hl: int, wq, wk, wv, kv_split: bool, whole, cfg: ArchConfig):
    """Model shard m's q (B, S, Hl, Dh) and k, v (its KV / M kv heads, or
    every kv head) from xm on its device: its column blocks (or the whole
    ``wk``/``wv``), its slice of the biases, the q/k norms."""
    B, S, _ = xm.shape
    dev, Dh = xm.device, cfg.resolved_head_dim()
    q = xm @ wq[m]
    k, v = (xm @ wk[m], xm @ wv[m]) if kv_split else (xm @ wk.to(dev), xm @ wv.to(dev))
    if cfg.qkv_bias:
        KVl = cfg.n_kv_heads // len(wq)
        kv_cols = slice(m * KVl * Dh, (m + 1) * KVl * Dh) if kv_split else slice(None)
        q = q + whole["bq"][m * Hl * Dh:(m + 1) * Hl * Dh].to(dev)
        k = k + whole["bk"][kv_cols].to(dev)
        v = v + whole["bv"][kv_cols].to(dev)
    q = q.reshape(B, S, Hl, Dh)
    k = k.reshape(B, S, -1, Dh)
    v = v.reshape(B, S, -1, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, whole["q_norm"].to(dev), cfg.norm_eps)
        k = rms_norm(k, whole["k_norm"].to(dev), cfg.norm_eps)
    return q, k, v


def _cache_shards(c, devices, name: str) -> List[torch.Tensor]:
    """Model shard m's cache tensor of a tensor-parallel decode: a list
    of one tensor a shard, on its device; anything else raises."""
    if not isinstance(c, list) or [t.device for t in c] != list(devices):
        raise ValueError(f"cache {name!r} is not a list of one tensor a model shard on "
                         f"{list(devices)}")
    return c


def _attention_decode_split(p: Params, x: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor,
                            cache: Dict[str, Any], window: int) -> torch.Tensor:
    """One decode step over M model shards: shard m projects the token as
    ``_attention_split`` does, writes its k and v (its kv heads, or every
    kv head) into its own cache tensors in place, runs ``decode_attention``
    on its Hl query heads against the kv heads they read (``_kv_heads``)
    and multiplies by its row block of ``wo``; ``_row_sum`` adds the f32
    partials."""
    B, _, d = x.shape
    home = x.device
    devices, Hl, G, wq, wo, wk, wv, kv_split, whole = _split_leaves(p, cfg, home)
    kc, vc, pc = (_cache_shards(cache[n], devices, n) for n in ("k", "v", "pos"))
    Dh = cfg.resolved_head_dim()
    partials = []
    with obs.span("tensor_parallel", kind="attn_decode", mp=len(devices),
                  partial_bytes=len(devices) * B * d * 4):
        for m, dev in enumerate(devices):
            pm = pos.to(dev)
            q, k, v = _project_shard(x.to(dev), m, Hl, wq, wk, wv, kv_split, whole, cfg)
            q, k = _position(q, k, _decode_positions(pm, cfg), cfg)
            _write_slot(kc[m], vc[m], pc[m], k, v, pm)
            keys, values = kc[m], vc[m]
            if not kv_split:
                keys, values = _kv_heads(keys, m, Hl, G), _kv_heads(values, m, Hl, G)
            o = decode_attention(q, keys, values, pc[m], pm, window=window)
            partials.append(_F32Product.apply(o.reshape(B, 1, Hl * Dh), wo[m]))
        return _row_sum(partials, home, x.dtype)


def _mlp_split(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU over M model shards: shard m's column blocks of ``w_gate``
    and ``w_up`` (d_ff / M columns), its row block of ``w_down``, the f32
    partials added by ``_row_sum``."""
    B, S, d = x.shape
    home = x.device
    devices = _split_devices(p["w_gate"], home, "w_gate")
    M = len(devices)
    gate, up = (_blocks(p[n], -1, devices, n) for n in ("w_gate", "w_up"))
    down = _blocks(p["w_down"], -2, devices, "w_down")
    partials = []
    with obs.span("tensor_parallel", kind="mlp", mp=M, partial_bytes=M * B * S * d * 4):
        for m, dev in enumerate(devices):
            xm = x.to(dev)
            partials.append(_F32Product.apply(F.silu(xm @ gate[m]) * (xm @ up[m]), down[m]))
        return _row_sum(partials, home, x.dtype)


# ------------------------------------------------------------------------- MoE


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device,
             lead: Tuple[int, ...] = ()) -> Params:
    """The MoE block's params: the router in f32 whatever ``dtype`` (the
    reference keeps it high-precision), the experts' SwiGLU stacked on an
    expert axis, and with ``dense_residual`` a dense MLP of ``d_ff``."""
    d, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    p: Params = {
        "router": dense_init(gen, (*lead, d, E), torch.float32, device),
        "w_gate": dense_init(gen, (*lead, E, d, F_), dtype, device),
        "w_up": dense_init(gen, (*lead, E, d, F_), dtype, device),
        "w_down": dense_init(gen, (*lead, E, F_, d), dtype, device),
    }
    if cfg.dense_residual:
        p["dense_mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, device, lead)
    return p


def _top_k(probs: torch.Tensor, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the K largest along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def _route_local(xf: torch.Tensor, router: torch.Tensor, E: int, K: int, capacity: int):
    """Top-K routing and each pair's rank within its expert. xf: (T, d).

    Returns (gate_vals (T, K), safe_expert (TK,), safe_rank (TK,), keep
    (TK,), aux): pairs in token-major order; a pair whose rank reaches
    ``capacity`` is dropped (keep False, expert and rank 0); aux is the
    Switch load-balance loss E * sum_e f_e p_e.
    """
    T = xf.shape[0]
    logits = xf.to(torch.float32) @ router  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, K)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_ids[:, 0], E).to(torch.float32).mean(dim=0)
    aux = E * (me * ce).sum()

    flat_expert = expert_ids.reshape(-1)  # (TK,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    first = torch.searchsorted(sorted_expert, torch.arange(E, device=xf.device), side="left")
    rank_sorted = torch.arange(T * K, device=xf.device) - first[sorted_expert]
    rank = torch.empty_like(rank_sorted).index_put_((order,), rank_sorted)
    keep = rank < capacity
    safe_expert = torch.where(keep, flat_expert, 0)
    safe_rank = torch.where(keep, rank, 0)
    return gate_vals, safe_expert, safe_rank, keep, aux


def _experts(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """The SwiGLU experts on their capacity buffers: (E, C, d) -> (E, C, d)."""
    h = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    return torch.bmm(F.silu(h) * u, w_down)


def _dispatch(xf: torch.Tensor, safe_expert, safe_rank, keep, E: int, K: int, C: int):
    """The (E, C, d) buffer: each kept pair's token in its (expert, rank)
    slot, zeros elsewhere.

    The reference scatter-adds each pair into its slot, at most one
    non-zero a slot; here the kept pairs are assigned to their slots and
    the dropped ones to a spare row past the buffer, which is cut off: the
    same buffer, with no host sync and no accumulation.
    """
    T, d = xf.shape
    tok_of = torch.arange(T * K, device=xf.device) // K
    slot = torch.where(keep, safe_expert * C + safe_rank, E * C)
    buf = xf.new_zeros((E * C + 1, d)).index_put((slot,), xf[tok_of])[: E * C]
    return buf.reshape(E, C, d)


def _moe_math_local(xf: torch.Tensor, p: Params, E: int, K: int, cap_factor: float):
    """Single-device MoE: route -> (E, C, d) buffer -> batched expert
    products -> gather and f32 combine. Returns ((T, d), aux)."""
    T, d = xf.shape
    C = max(1, int(T * K / E * cap_factor))
    gate_vals, safe_expert, safe_rank, keep, aux = _route_local(xf, p["router"], E, K, C)
    buf = _dispatch(xf, safe_expert, safe_rank, keep, E, K, C)
    y = _experts(buf, *(_expert_block(p[n], (0, E), xf.device)
                        for n in ("w_gate", "w_up", "w_down")))  # (E, C, d)
    gathered = y.reshape(E * C, d)[safe_expert * C + safe_rank]  # (TK, d)
    gate = torch.where(keep, gate_vals.reshape(-1), torch.zeros((), device=xf.device))
    weighted = gathered.to(torch.float32) * gate[:, None]
    out = weighted.reshape(T, K, d).sum(dim=1)
    return out.to(xf.dtype), aux


def _mesh_info():
    mesh = get_abstract_mesh()
    if mesh.empty:
        return None
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = 1
    for a in dp_axes:
        dp *= sizes[a]
    return {"sizes": sizes, "dp_axes": dp_axes, "dp": dp,
            "mp": sizes.get("model", 1)}


def moe_uses_shard_map(info, E: int, K: int, T: int) -> bool:
    """Route MoE through the expert-parallel path?

    Requires a model axis to parallelise over, divisible experts/tokens,
    and enough routed work per device to amortise gathering the local
    expert weights: decode steps route T_loc*K << E pairs, where the
    reference measured its GSPMD fallback cheaper (1.9 s vs 5.2 s of
    collectives on kimi decode_32k).
    """
    return (
        info is not None and info["mp"] > 1 and E % info["mp"] == 0
        and T % info["dp"] == 0
        and (T // info["dp"]) * K >= E
    )


def _shard_devices(mesh, info) -> np.ndarray:
    """The mesh's devices as a (dp, mp) array: row i is data shard i (over
    ("pod", "data"), major first), column m model shard m; any other axis
    at index 0 (the reference's shard_map replicates over it)."""
    names = list(mesh.axis_names)
    order = [names.index(a) for a in info["dp_axes"]] + [names.index("model")]
    rest = [i for i in range(len(names)) if i not in order]
    devs = np.transpose(mesh.devices, order + rest)[(Ellipsis,) + (0,) * len(rest)]
    return devs.reshape(info["dp"], info["mp"])


def _expert_block(w, rows, device) -> torch.Tensor:
    """Rows ``rows`` of dim 0 of an expert leaf on ``device``: a view of a
    tensor that already sits there, or the block of a placed leaf
    (``launch.sharding.Placed``). A tensor on another device raises: the
    forward never copies an expert stack; place it first."""
    if not isinstance(w, torch.Tensor):
        return w.block(rows, device)
    if w.device != device:
        raise ValueError(f"an expert leaf on {w.device} is read on {device}: place the "
                         "expert weights on the mesh (launch.sharding.place)")
    return w[rows[0]:rows[1]]


def _moe_shard(xi: torch.Tensor, p: Params, E: int, K: int, C: int, devices, plain: bool):
    """One data shard's tokens xi (T_loc, d) through the reference's
    ``inner``: route locally at capacity C, dispatch into (M, E_loc, C, d),
    run model shard m's E_loc experts on ``devices[m]`` (``plain``: every
    expert in one product on xi's device), gather, and weight with the gate
    in the activation dtype. Returns ((T_loc, d), aux)."""
    T_loc, d = xi.shape
    home = xi.device
    M = len(devices)
    E_loc = E // M
    gate_vals, safe_expert, safe_rank, keep, aux = _route_local(
        xi, _expert_block(p["router"], (0, p["router"].shape[0]), home), E, K, C)
    send = _dispatch(xi, safe_expert, safe_rank, keep, E, K, C)
    names = ("w_gate", "w_up", "w_down")
    if plain:
        y = _experts(send, *(p[n] for n in names))
    else:
        ys = []
        for m, dev in enumerate(devices):
            rows = (m * E_loc, (m + 1) * E_loc)
            ys.append(_experts(send[rows[0]:rows[1]].to(dev),
                               *(_expert_block(p[n], rows, dev) for n in names)).to(home))
        y = torch.cat(ys)  # (E, C, d)
    gathered = y.reshape(E * C, d)[safe_expert * C + safe_rank]  # (T_loc K, d), stays bf16
    gate = torch.where(keep, gate_vals.reshape(-1), torch.zeros((), device=home))
    weighted = gathered * gate[:, None].to(gathered.dtype)
    return weighted.reshape(T_loc, K, d).sum(dim=1).to(xi.dtype), aux


def _moe_sharded(p: Params, x: torch.Tensor, cfg: ArchConfig, devices: np.ndarray,
                 capacity_factor: float, plain: bool):
    """The expert-parallel MoE over a (dp, mp) array of devices: data shard
    i's T // dp token rows go through ``_moe_shard`` on ``devices[i]`` (the
    plain version: on x's device), and come back to x's device. aux is the
    mean over the data shards (the reference's pmean over every device)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    dp, M = devices.shape
    T_loc = B * S // dp
    C = max(1, int(T_loc * K / E * capacity_factor))
    xf = x.reshape(B * S, d)
    outs, auxs = [], []
    with obs.span("moe_shard_map", dp=dp, mp=M, tokens=T_loc, capacity=C, plain=plain):
        for i in range(dp):
            xi = xf[i * T_loc:(i + 1) * T_loc]
            row = [x.device] * M if plain else list(devices[i])
            o, a = _moe_shard(xi.to(row[0]), p, E, K, C, row, plain)
            outs.append(o.to(x.device))
            auxs.append(a.to(x.device))
    out = torch.cat(outs).reshape(B, S, d)
    if cfg.dense_residual:
        out = out + mlp_block(p["dense_mlp"], x)
    return out, torch.stack(auxs).mean()


def moe_sharded_plain(p: Params, x: torch.Tensor, cfg: ArchConfig, dp: int, mp: int, *,
                      capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel branch's plain version: the same per-shard math
    (dp data shards routed apart at their own capacity, the gate weighted
    in the activation dtype) on x's device, every expert in one product
    and no device moves. ``mp`` only checks that the experts divide."""
    if cfg.n_experts % mp or (x.shape[0] * x.shape[1]) % dp:
        raise ValueError(f"{cfg.n_experts} experts over {mp} shards or "
                         f"{x.shape[0] * x.shape[1]} tokens over {dp} do not divide")
    devices = np.empty((dp, mp), dtype=object)
    devices[:] = x.device
    return _moe_sharded(p, x, cfg, devices, capacity_factor, plain=True)


def moe_block(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux load-balance loss).

    Under an ambient mesh (``util.use_mesh``) with a ``model`` axis, when
    ``moe_uses_shard_map`` holds, the reference's expert-parallel path:
    tokens stay on their data shard, routing and dispatch are local to it,
    and model shard m's experts run on that shard's device
    (``_moe_sharded``); the expert weights are views of tensors on those
    devices or placed leaves (``launch.sharding.place``). Otherwise one
    device: every expert computes over its (C, d) capacity buffer. Pairs
    past an expert's capacity are dropped (GShard-style). With
    ``dense_residual`` the dense MLP's output is added.
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    info = _mesh_info()
    if moe_uses_shard_map(info, E, K, B * S):
        devices = _shard_devices(get_abstract_mesh(), info)
        return _moe_sharded(p, x, cfg, devices, capacity_factor, plain=False)
    out, aux = _moe_math_local(x.reshape(B * S, d), p, E, K, capacity_factor)
    out = out.reshape(B, S, d)
    if cfg.dense_residual:
        out = out + mlp_block(p["dense_mlp"], x)
    return out, aux
