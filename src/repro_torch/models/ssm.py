"""State-space model blocks of the port (the JAX package's
``models/ssm.py``): Mamba-1 (falcon-mamba) and Mamba-2 / SSD (zamba2).

- **Mamba-1**: the reference's two-level chunked scan, kept pass for pass
  (a plain recurrence over T is one launch per step and rounds
  differently): an intra-chunk recurrence over the chunk length L with
  every chunk advancing in lockstep, the inter-chunk recurrence over the
  T / L chunk boundaries, then the intra-chunk pass again seeded with the
  right boundary states. f32 inside.
- **Mamba-2 (SSD)**: the chunked matrix form: attention-like products
  inside a chunk, a scalar-per-head recurrence between chunks. The
  reference's three-operand einsums are written as pairwise products
  whose intermediates stay at (B, NC, L, L, H) or (B, NC, L, H, P) (a bad
  pairing of ``bcln,bclh,bchpn`` would hold a (B, NC, L, H, P, N) tensor).

Neither scan has a kernel of its own in either package: they are plain
PyTorch on the card too. ``mamba1_scan_plain`` and ``ssd_scan_plain`` are
the step-by-step recurrences the reference's tests hold the scans
against, kept here as the scans' plain versions.

Both block kinds have a single-step ``*_decode`` carrying (ssm state, conv
state); the conv state is the last K - 1 pre-conv inputs, left-padded
with zeros when fewer have been seen.

Given block leaves (the sharded steps' tensor-parallel route, every leaf
of the block split on its ``MAMBA1_SPLIT`` / ``MAMBA2_SPLIT`` dim over
the model shards), each block runs a model shard's share: Mamba-1 its
d_inner / M channels, Mamba-2 its H / M heads (``_mamba1_shards``,
``_mamba2_shards``); its states are then one tensor a model shard.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs import ArchConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), no linear branch above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _pad_t(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (time) of ``a`` at the end by ``pad``."""
    return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) if pad else a


def _conv_tail(x: torch.Tensor, K: int) -> torch.Tensor:
    """The last K - 1 pre-conv inputs of x (B, T, C), left-padded with
    zeros when T < K - 1: the conv state a following decode step reads.
    A copy: a view of a padded input would keep all of it alive while the
    prefill collects every layer's tail."""
    tail = x[:, x.shape[1] - min(K - 1, x.shape[1]):]
    return F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0)).clone()


# ------------------------------------------------------- depthwise causal conv


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C); w: (K, C) depthwise taps; b: (C,). Causal (left pad):
    K shifted multiply-adds in x's dtype, as the reference (a conv op
    accumulates bf16 differently)."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + T] * w[i]
    return out + b


def conv1d_decode(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-step depthwise conv. x_t: (B, C); conv_state: (B, K - 1, C).
    Returns (out (B, C), the next conv state (B, K - 1, C))."""
    full = torch.cat([conv_state, x_t[:, None]], dim=1)  # (B, K, C)
    out = torch.einsum("bkc,kc->bc", full, w) + b
    return out, full[:, 1:]


# -------------------------------------------- Mamba-1 selective scan (diagonal A)


def _mamba1_chunked_scan(
    dt: torch.Tensor,  # (B, T, d) softplus'd step sizes
    A: torch.Tensor,  # (d, N) negative
    Bm: torch.Tensor,  # (B, T, N)
    Cm: torch.Tensor,  # (B, T, N)
    x: torch.Tensor,  # (B, T, d)
    h0: torch.Tensor,  # (B, d, N) initial state
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, d), h_final (B, d, N)), f32."""
    B_, T, d = x.shape
    N = A.shape[1]
    Lc = min(chunk, T)
    nc = -(-T // Lc)
    pad = nc * Lc - T
    dt_c = _pad_t(dt, pad).reshape(B_, nc, Lc, d).to(torch.float32)
    B_c = _pad_t(Bm, pad).reshape(B_, nc, Lc, N).to(torch.float32)
    C_c = _pad_t(Cm, pad).reshape(B_, nc, Lc, N).to(torch.float32)
    x_c = _pad_t(x, pad).reshape(B_, nc, Lc, d).to(torch.float32)
    Af = A.to(torch.float32)

    def step_terms(t):
        dt_t, B_t, x_t = dt_c[:, :, t], B_c[:, :, t], x_c[:, :, t]
        a_t = torch.exp(dt_t[..., None] * Af)  # (B, NC, d, N); A < 0: a in (0, 1]
        b_t = (dt_t * x_t)[..., None] * B_t[:, :, None, :]  # (B, NC, d, N)
        return a_t, b_t

    # pass 1: every chunk's local final state (seed 0) and its decay product
    h = torch.zeros((B_, nc, d, N), dtype=torch.float32, device=x.device)
    a_chunk = torch.ones_like(h)
    for t in range(Lc):
        a_t, b_t = step_terms(t)
        h = a_t * h + b_t
        a_chunk = a_chunk * a_t
    h_local = h

    # pass 2: the recurrence over chunk boundaries; H_in[c] enters chunk c
    H = h0.to(torch.float32)
    H_in = []
    for c in range(nc):
        H_in.append(H)
        H = a_chunk[:, c] * H + h_local[:, c]
    h_final = H
    h = torch.stack(H_in, dim=1)  # (B, NC, d, N)

    # pass 3: the intra-chunk recurrence again from the right seeds
    ys = []
    for t in range(Lc):
        a_t, b_t = step_terms(t)
        h = a_t * h + b_t
        ys.append(torch.einsum("bcdn,bcn->bcd", h, C_c[:, :, t]))
    y = torch.stack(ys, dim=2).reshape(B_, nc * Lc, d)[:, :T]
    return y, h_final


def mamba1_scan_plain(dt, A, Bm, Cm, x, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 recurrence one step at a time (the reference's test
    oracle): the chunked scan's plain version. f32."""
    dt, A, Bm, Cm, x = (a.to(torch.float32) for a in (dt, A, Bm, Cm, x))
    h = h0.to(torch.float32)
    ys = []
    for t in range(x.shape[1]):
        a = torch.exp(dt[:, t, :, None] * A)
        h = a * h + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def _log_dt_bias(gen, shape, device) -> torch.Tensor:
    """softplus^-1 of a step size drawn log-uniform in [1e-3, 0.1], f32."""
    lo, hi = math.log(0.001), math.log(0.1)

    def fill(w):
        w.uniform_(generator=gen)
        w.mul_(hi - lo).add_(lo).exp_().expm1_().log_()

    return L._draw(shape, torch.float32, device, fill)


def _conv_init(gen, shape, dtype, device) -> torch.Tensor:
    K = shape[-2]

    def fill(w):
        w.normal_(generator=gen).mul_(K**-0.5)

    return L._draw(shape, dtype, device, fill)


def init_mamba1(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device,
                lead: Tuple[int, ...] = ()) -> Params:
    """One Mamba-1 block's params (``lead`` prepends the stacked layer
    axes). ``A_log``, ``D`` and ``dt_bias`` are f32 whatever ``dtype``.
    ``dt_proj``'s fan-in std is R^-0.5, the reference's explicit scale."""
    d, di, N = cfg.d_model, cfg.resolved_d_inner(), cfg.ssm_state
    R, K = cfg.resolved_dt_rank(), cfg.ssm_conv
    # S4D-real initialisation: A = 1..N on every channel
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": L.dense_init(gen, (*lead, d, 2 * di), dtype, device),
        "conv_w": _conv_init(gen, (*lead, K, di), dtype, device),
        "conv_b": torch.zeros((*lead, di), dtype=dtype, device=device),
        "x_proj": L.dense_init(gen, (*lead, di, R + 2 * N), dtype, device),
        "dt_proj": L.dense_init(gen, (*lead, R, di), dtype, device),
        "dt_bias": _log_dt_bias(gen, (*lead, di), device),
        "A_log": torch.log(A).expand(*lead, di, N).contiguous(),
        "D": torch.ones((*lead, di), dtype=torch.float32, device=device),
        "out_proj": L.dense_init(gen, (*lead, di, d), dtype, device),
    }


def _mamba1_inner(p: Params, xz: torch.Tensor, cfg: ArchConfig, h0: torch.Tensor,
                  conv_state=None):
    """The block between in_proj and out_proj. xz: (B, T, 2 di). Returns
    (out, h_final, conv state); decode runs the chunked scan at T = 1."""
    di, N, R = cfg.resolved_d_inner(), cfg.ssm_state, cfg.resolved_dt_rank()
    x, z = xz[..., :di], xz[..., di:]
    if conv_state is None:
        new_conv = _conv_tail(x, p["conv_w"].shape[0])
        x = causal_conv1d(x, p["conv_w"], p["conv_b"])
    else:
        xc, new_conv = conv1d_decode(x[:, 0], conv_state, p["conv_w"], p["conv_b"])
        x = xc[:, None]
    x = F.silu(x)
    proj = x @ p["x_proj"]  # (B, T, R + 2N)
    # a compute-dtype product plus the f32 bias: f32, as the reference
    dt = _softplus(proj[..., :R] @ p["dt_proj"] + p["dt_bias"])
    Bm = proj[..., R:R + N]
    Cm = proj[..., R + N:]
    A = -torch.exp(p["A_log"])
    y, h_final = _mamba1_chunked_scan(dt, A, Bm, Cm, x, h0)
    y = y + x.to(torch.float32) * p["D"]
    y = y.to(xz.dtype) * F.silu(z)
    return y @ p["out_proj"], h_final, new_conv


def mamba1_prefill(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """The block over a whole sequence from a zero state: (out, h_final,
    conv tail); with block leaves (``_mamba1_shards``) the states are lists
    of each model shard's."""
    if _is_split(p):
        return _mamba1_shards(p, x, cfg)
    h0 = torch.zeros((x.shape[0], cfg.resolved_d_inner(), cfg.ssm_state), dtype=torch.float32,
                     device=x.device)
    return _mamba1_inner(p, x @ p["in_proj"], cfg, h0)


def mamba1_block(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return mamba1_prefill(p, x, cfg)[0]


def mamba1_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, state: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """x: (B, 1, d); state = {"h": (B, di, N), "conv": (B, K - 1, di)}.
    Returns (out, the new state). With block leaves the state's leaves are
    lists of each model shard's tensors, written in place, and ``state``
    itself comes back."""
    if _is_split(p):
        out, hs, convs = _mamba1_shards(p, x, cfg, state)
        _write_states(state, hs, convs)
        return out, state
    out, h_final, new_conv = _mamba1_inner(p, x @ p["in_proj"], cfg, state["h"],
                                           conv_state=state["conv"])
    return out, {"h": h_final, "conv": new_conv}


# ------------------------------------------------ tensor parallelism (Mamba-1/-2)
#
# The sharded steps' tensor-parallel route splits a Mamba block over the
# model shards by channel (Mamba-1) or by head (Mamba-2). Model shard m
# multiplies the input by its own column block of ``in_proj`` and takes
# the columns its channels read from every shard's output (the
# activations move, not the weight); it convolves its channels, runs the
# scan on them (independent per channel, or per head given dt, B and C)
# and multiplies by its row block of ``out_proj``: an f32 partial that
# ``layers._row_sum`` adds in shard order on the input's device.
# Mamba-1's ``x_proj`` contracts over the channels: each shard's rows give
# an f32 partial, summed the same way and sent back to every shard.
# Mamba-2's conv runs on a uniform split of its x|B|C channels; each shard
# then takes its heads' x channels and every shard B and C from the conv's
# outputs; its gated RMS norm over all of d_inner adds each shard's f32
# sum of squares in shard order.

# the dim (from the end) each leaf splits on: channels, heads or columns
MAMBA1_SPLIT = {"in_proj": -1, "conv_w": -1, "conv_b": -1, "x_proj": -2, "dt_proj": -1,
                "dt_bias": -1, "A_log": -2, "D": -1, "out_proj": -2}
MAMBA2_SPLIT = {"in_proj": -1, "conv_w": -1, "conv_b": -1, "A_log": -1, "D": -1, "dt_bias": -1,
                "gate_norm": -1, "out_proj": -2}


def split_axis(cfg: ArchConfig, name: str, M: int) -> Optional[int]:
    """The dim (from the end) on which the tensor-parallel route reads a
    Mamba block's leaf ``name`` over ``M`` model shards, or None where the
    block runs whole: Mamba-1 splits where d_inner divides M; Mamba-2
    where its heads, its conv channels (x, B and C) and ``in_proj``'s
    columns do."""
    di, N = cfg.resolved_d_inner(), cfg.ssm_state
    if cfg.family == "ssm":
        return MAMBA1_SPLIT.get(name) if di % M == 0 else None
    H = cfg.resolved_ssm_heads()
    whole = (H % M or (di + 2 * N) % M or (2 * di + 2 * N + H) % M)
    return None if whole else MAMBA2_SPLIT.get(name)


def _is_split(p: Params) -> bool:
    """Whether a Mamba block's leaves are block leaves; a block split in
    part raises (no fallback)."""
    split = [n for n, w in p.items() if not isinstance(w, torch.Tensor)]
    if split and len(split) != len(p):
        raise ValueError(f"only {sorted(split)} of the Mamba block are split over the model axis")
    return bool(split)


def _split_weights(p: Params, axes: Dict[str, int], home: torch.device):
    """(devices, {name: each model shard's block}) of a split block."""
    devices = L._split_devices(p["out_proj"], home, "out_proj")
    return devices, {n: L._blocks(p[n], ax, devices, n) for n, ax in axes.items()}


def _write_states(state: Dict[str, List[torch.Tensor]], hs, convs) -> None:
    """A split decode's new states into each model shard's own tensors."""
    for dst, new in zip(state["h"], hs):
        dst.copy_(new)
    for dst, new in zip(state["conv"], convs):
        dst.copy_(new)


def _x_proj_split(xs: List[torch.Tensor], blocks: List[torch.Tensor], home: torch.device):
    """Mamba-1's ``x_proj`` over the channel shards: shard m's channels
    times its rows, an f32 partial; the partials summed in shard order on
    ``home`` and the (B, T, R + 2N) result sent back to every shard."""
    proj = L._row_sum([L._F32Product.apply(x, w) for x, w in zip(xs, blocks)], home, xs[0].dtype)
    return [proj.to(x.device) for x in xs]


def _out_proj_split(ys: List[torch.Tensor], blocks: List[torch.Tensor], home: torch.device,
                    dtype) -> torch.Tensor:
    """``out_proj`` row-parallel: each shard's f32 partial, summed in shard
    order on ``home``."""
    return L._row_sum([L._F32Product.apply(y, w) for y, w in zip(ys, blocks)], home, dtype)


def _gate_norm_split(gs: List[torch.Tensor], weights: List[torch.Tensor], home: torch.device,
                     width: int, eps: float) -> List[torch.Tensor]:
    """``layers.rms_norm`` over ``width`` channels cut into the shards'
    ``gs``: each shard's f32 sum of squares summed in shard order on
    ``home``, the inverse root sent back and each shard's channels scaled
    by it and by its slice of the weight."""
    sq = [g.to(torch.float32).square().sum(dim=-1, keepdim=True) for g in gs]
    r = torch.rsqrt(L._row_sum(sq, home, torch.float32) / width + eps)
    return [(g.to(torch.float32) * r.to(g.device) * w.to(torch.float32)).to(g.dtype)
            for g, w in zip(gs, weights)]


def _mamba1_shards(p: Params, x: torch.Tensor, cfg: ArchConfig, state=None):
    """A Mamba-1 block over M model shards, d_inner / M channels each; x
    (B, T, d) on the first shard's device. ``state`` None: the prefill
    from a zero state; else a decode step from ``state``'s lists of each
    shard's "h" (B, di / M, N) and "conv" (B, K - 1, di / M). Returns (out,
    [h_final], [conv state]), the states a tensor a shard on its device."""
    B_, T, d = x.shape
    home, dt = x.device, x.dtype
    di, N, R, K = cfg.resolved_d_inner(), cfg.ssm_state, cfg.resolved_dt_rank(), cfg.ssm_conv
    devices, w = _split_weights(p, MAMBA1_SPLIT, home)
    M = len(devices)
    if di % M:
        raise ValueError(f"{di} channels do not divide over {M} model shards")
    dl = di // M
    with obs.span("tensor_parallel", kind="mamba1" if state is None else "mamba1_decode", mp=M,
                  partial_bytes=M * B_ * T * (d + R + 2 * N) * 4):
        outs = [x.to(dev) @ b for dev, b in zip(devices, w["in_proj"])]
        xs, zs, convs = [], [], []
        for m, dev in enumerate(devices):
            xm = L._cols(outs, m * dl, (m + 1) * dl, dev)
            zs.append(L._cols(outs, di + m * dl, di + (m + 1) * dl, dev))
            if state is None:
                convs.append(_conv_tail(xm, K))
                xm = causal_conv1d(xm, w["conv_w"][m], w["conv_b"][m])
            else:
                xc, new_conv = conv1d_decode(xm[:, 0], state["conv"][m], w["conv_w"][m],
                                             w["conv_b"][m])
                convs.append(new_conv)
                xm = xc[:, None]
            xs.append(F.silu(xm))
        projs = _x_proj_split(xs, w["x_proj"], home)
        ys, hs = [], []
        for m, dev in enumerate(devices):
            proj = projs[m]
            dtm = _softplus(proj[..., :R] @ w["dt_proj"][m] + w["dt_bias"][m])
            h0 = (torch.zeros((B_, dl, N), dtype=torch.float32, device=dev) if state is None
                  else state["h"][m])
            y, h_final = _mamba1_chunked_scan(dtm, -torch.exp(w["A_log"][m]), proj[..., R:R + N],
                                              proj[..., R + N:], xs[m], h0)
            y = y + xs[m].to(torch.float32) * w["D"][m]
            ys.append(y.to(dt) * F.silu(zs[m]))
            hs.append(h_final)
        return _out_proj_split(ys, w["out_proj"], home, dt), hs, convs


# ------------------------------------------ Mamba-2 (SSD): scalar decay per head


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device,
                lead: Tuple[int, ...] = ()) -> Params:
    """One Mamba-2 block's params; ``A_log``, ``D`` and ``dt_bias`` f32."""
    d, di, H = cfg.d_model, cfg.resolved_d_inner(), cfg.resolved_ssm_heads()
    N, K = cfg.ssm_state, cfg.ssm_conv
    conv_dim = di + 2 * N  # x, B and C go through the conv

    def fill_a_log(w):  # log of A drawn log-uniform in [1, 16]
        w.uniform_(generator=gen).mul_(math.log(16.0) - math.log(1.0)).add_(math.log(1.0))
        w.exp_().log_()

    return {
        "in_proj": L.dense_init(gen, (*lead, d, 2 * di + 2 * N + H), dtype, device),
        "conv_w": _conv_init(gen, (*lead, K, conv_dim), dtype, device),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=device),
        "A_log": L._draw((*lead, H), torch.float32, device, fill_a_log),
        "D": torch.ones((*lead, H), dtype=torch.float32, device=device),
        "dt_bias": _log_dt_bias(gen, (*lead, H), device),
        "gate_norm": torch.ones((*lead, di), dtype=dtype, device=device),
        "out_proj": L.dense_init(gen, (*lead, di, d), dtype, device),
    }


def _ssd_scan(
    x: torch.Tensor,  # (B, T, H, P) head inputs
    dt: torch.Tensor,  # (B, T, H) softplus'd
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B, T, N)
    Cm: torch.Tensor,  # (B, T, N)
    h0: torch.Tensor,  # (B, H, P, N)
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD chunked algorithm. Returns (y (B, T, H, P), h_final), f32."""
    B_, T, H, Pd = x.shape
    N = Bm.shape[-1]
    Lc = min(chunk, T)
    nc = -(-T // Lc)
    pad = nc * Lc - T
    xf = _pad_t(x, pad).reshape(B_, nc, Lc, H, Pd).to(torch.float32)
    dtf = _pad_t(dt, pad).reshape(B_, nc, Lc, H).to(torch.float32)
    Bf = _pad_t(Bm, pad).reshape(B_, nc, Lc, N).to(torch.float32)
    Cf = _pad_t(Cm, pad).reshape(B_, nc, Lc, N).to(torch.float32)

    cum = torch.cumsum(dtf * A, dim=2)  # inclusive cumulative log-decay (B, NC, L, H)

    # intra-chunk: M[t, s] = exp(cum[t] - cum[s]) for t >= s (<= 1). The
    # exponent is masked before exp: above the diagonal it is positive and
    # could overflow, and exp(-inf) = 0 keeps inf * 0 out of the backward
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, NC, L, L, H)
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    M = torch.exp(seg.masked_fill(~tri[None, None, :, :, None], float("-inf")))
    scores = Cf @ Bf.transpose(-1, -2)  # bcln,bcmn->bclm
    xdt = xf * dtf[..., None]  # (B, NC, L, H, P)
    # bclm,bclmh,bcmhp->bclhp as (scores * M), then a product over m per head
    W = (scores[..., None] * M).permute(0, 1, 4, 2, 3)  # (B, NC, H, L, L)
    y_intra = (W @ xdt.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # chunk-final states from a zero seed: sum_s exp(cum[-1] - cum[s]) B_s x_s dt_s
    # (bclh,bcln,bclhp->bchpn as the weighting, then a product over l)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, NC, L, H)
    u = (decay_to_end[..., None] * xdt).reshape(B_, nc, Lc, H * Pd)
    S_c = (u.transpose(-1, -2) @ Bf).reshape(B_, nc, H, Pd, N)

    # inter-chunk recurrence: a scalar decay per head and chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, NC, H)
    Hc = h0.to(torch.float32)
    H_in = []
    for c in range(nc):
        H_in.append(Hc)
        Hc = chunk_decay[:, c][:, :, None, None] * Hc + S_c[:, c]
    h_final = Hc
    H_in = torch.stack(H_in, dim=1)  # (B, NC, H, P, N)

    # the entering state's share: y_t += C_t . (exp(cum[t]) H_in)
    # (bcln,bclh,bchpn->bclhp as a product over n, then the decay)
    v = Cf @ H_in.reshape(B_, nc, H * Pd, N).transpose(-1, -2)  # (B, NC, L, H P)
    y_inter = v.reshape(B_, nc, Lc, H, Pd) * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(B_, nc * Lc, H, Pd)[:, :T]
    return y, h_final


def ssd_scan_plain(x, dt, A, Bm, Cm, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence one step at a time (the reference's test
    oracle): the chunked scan's plain version. f32."""
    x, dt, A, Bm, Cm = (a.to(torch.float32) for a in (x, dt, A, Bm, Cm))
    h = h0.to(torch.float32)
    ys = []
    for t in range(x.shape[1]):
        y, h = _ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


def _ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the SSD recurrence, f32: x (B, H, P), dt (B, H), A (H,),
    Bm and Cm (B, N), h (B, H, P, N). Returns (y (B, H, P), the new h)."""
    decay = torch.exp(dt * A)  # (B, H)
    upd = (x * dt[..., None])[..., None] * Bm[:, None, None, :]  # bhp,bn->bhpn
    h_new = decay[:, :, None, None] * h + upd
    return torch.einsum("bhpn,bn->bhp", h_new, Cm), h_new


def _mamba2_split(p: Params, zxbcdt: torch.Tensor, cfg: ArchConfig):
    di, N = cfg.resolved_d_inner(), cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * N]
    dt_raw = zxbcdt[..., 2 * di + 2 * N:]  # (B, T, H)
    return z, xBC, dt_raw


def mamba2_block(p: Params, x_in: torch.Tensor, cfg: ArchConfig, return_state: bool = False):
    """Returns (out, state | None); state = {"h", "conv"} primes decode
    (with block leaves, ``_mamba2_split``, lists of each model shard's)."""
    if _is_split(p):
        out, hs, convs = _mamba2_shards(p, x_in, cfg)
        return out, ({"h": hs, "conv": convs} if return_state else None)
    B_, T, _ = x_in.shape
    di, N, H = cfg.resolved_d_inner(), cfg.ssm_state, cfg.resolved_ssm_heads()
    Pd = di // H
    z, xBC, dt_raw = _mamba2_split(p, x_in @ p["in_proj"], cfg)
    conv_tail = _conv_tail(xBC, p["conv_w"].shape[0])
    xBC = F.silu(causal_conv1d(xBC, p["conv_w"], p["conv_b"]))
    x = xBC[..., :di].reshape(B_, T, H, Pd)
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]
    dt = _softplus(dt_raw + p["dt_bias"])  # compute dtype + f32 bias: f32
    A = -torch.exp(p["A_log"])
    h0 = torch.zeros((B_, H, Pd, N), dtype=torch.float32, device=x_in.device)
    y, h_final = _ssd_scan(x, dt, A, Bm, Cm, h0)
    y = y + x.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(B_, T, di).to(x_in.dtype)
    y = L.rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        return out, {"h": h_final, "conv": conv_tail}
    return out, None


def mamba2_decode(p: Params, x_in: torch.Tensor, cfg: ArchConfig,
                  state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The single-step SSD recurrence. state = {"h": (B, H, P, N), "conv":
    (B, K - 1, conv_dim)}. Returns (out, the new state). With block leaves
    the state's leaves are lists of each model shard's tensors, written in
    place, and ``state`` itself comes back."""
    if _is_split(p):
        out, hs, convs = _mamba2_shards(p, x_in, cfg, state)
        _write_states(state, hs, convs)
        return out, state
    B_ = x_in.shape[0]
    di, N, H = cfg.resolved_d_inner(), cfg.ssm_state, cfg.resolved_ssm_heads()
    Pd = di // H
    z, xBC, dt_raw = _mamba2_split(p, x_in @ p["in_proj"], cfg)
    xBC_t, new_conv = conv1d_decode(xBC[:, 0], state["conv"], p["conv_w"], p["conv_b"])
    xBC_t = F.silu(xBC_t)
    x = xBC_t[..., :di].reshape(B_, H, Pd).to(torch.float32)
    Bm = xBC_t[..., di:di + N].to(torch.float32)
    Cm = xBC_t[..., di + N:].to(torch.float32)
    dt = _softplus(dt_raw[:, 0] + p["dt_bias"])  # (B, H)
    y, h_new = _ssd_step(x, dt, -torch.exp(p["A_log"]), Bm, Cm,
                         state["h"].to(torch.float32))
    y = y + x * p["D"][None, :, None]
    y = y.reshape(B_, 1, di).to(x_in.dtype)
    y = L.rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"h": h_new, "conv": new_conv}


def _mamba2_shards(p: Params, x_in: torch.Tensor, cfg: ArchConfig, state=None):
    """A Mamba-2 block over M model shards, H / M heads each; x_in (B, T,
    d) on the first shard's device. The conv runs on shard m's uniform
    slice of the x|B|C channels (its pieces of ``conv_w`` and of the conv
    state); shard m then reads its heads' x channels and all of B and C
    from the conv's outputs, and its z and dt columns from ``in_proj``'s.
    ``state`` None: the prefill from a zero state; else a decode step from
    ``state``'s lists of each shard's "h" (B, H / M, P, N) and "conv" (B,
    K - 1, conv_dim / M). Returns (out, [h_final], [conv state])."""
    B_, T, d = x_in.shape
    home, dt = x_in.device, x_in.dtype
    di, N, H, K = cfg.resolved_d_inner(), cfg.ssm_state, cfg.resolved_ssm_heads(), cfg.ssm_conv
    Pd = di // H
    devices, w = _split_weights(p, MAMBA2_SPLIT, home)
    M = len(devices)
    if split_axis(cfg, "out_proj", M) is None:
        raise ValueError(f"{H} heads, {di + 2 * N} conv channels or {2 * di + 2 * N + H} "
                         f"in_proj columns do not divide over {M} model shards")
    Hl, dl, cc = H // M, di // M, (di + 2 * N) // M
    with obs.span("tensor_parallel", kind="mamba2" if state is None else "mamba2_decode", mp=M,
                  partial_bytes=M * B_ * T * (d + 1) * 4):
        outs = [x_in.to(dev) @ b for dev, b in zip(devices, w["in_proj"])]
        cs, convs = [], []
        for m, dev in enumerate(devices):
            xbc = L._cols(outs, di + m * cc, di + (m + 1) * cc, dev)
            if state is None:
                convs.append(_conv_tail(xbc, K))
                cs.append(F.silu(causal_conv1d(xbc, w["conv_w"][m], w["conv_b"][m])))
            else:
                c, new_conv = conv1d_decode(xbc[:, 0], state["conv"][m], w["conv_w"][m],
                                            w["conv_b"][m])
                convs.append(new_conv)
                cs.append(F.silu(c)[:, None])
        gs, hs = [], []
        for m, dev in enumerate(devices):
            z = L._cols(outs, m * dl, (m + 1) * dl, dev)
            dt_raw = L._cols(outs, 2 * di + 2 * N + m * Hl, 2 * di + 2 * N + (m + 1) * Hl, dev)
            xm = L._cols(cs, m * dl, (m + 1) * dl, dev)
            bc = L._cols(cs, di, di + 2 * N, dev)
            A = -torch.exp(w["A_log"][m])
            if state is None:
                x4 = xm.reshape(B_, T, Hl, Pd)
                h0 = torch.zeros((B_, Hl, Pd, N), dtype=torch.float32, device=dev)
                y, h_final = _ssd_scan(x4, _softplus(dt_raw + w["dt_bias"][m]), A,
                                       bc[..., :N], bc[..., N:], h0)
                y = y + x4.to(torch.float32) * w["D"][m][None, None, :, None]
            else:
                x3 = xm[:, 0].reshape(B_, Hl, Pd).to(torch.float32)
                bt = bc[:, 0].to(torch.float32)
                y, h_final = _ssd_step(x3, _softplus(dt_raw[:, 0] + w["dt_bias"][m]), A,
                                       bt[..., :N], bt[..., N:], state["h"][m].to(torch.float32))
                y = y + x3 * w["D"][m][None, :, None]
            gs.append(y.reshape(B_, T, dl).to(dt) * F.silu(z))
            hs.append(h_final)
        gs = _gate_norm_split(gs, w["gate_norm"], home, di, cfg.norm_eps)
        return _out_proj_split(gs, w["out_proj"], home, dt), hs, convs
