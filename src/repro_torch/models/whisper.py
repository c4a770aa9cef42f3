"""Whisper-tiny style encoder-decoder of the port (the JAX package's
``models/whisper.py``); the mel and conv frontend is a stub.

Callers provide precomputed frame embeddings (B, T_enc, frontend_dim),
which ``frame_proj`` maps to d_model. The encoder is non-causal
self-attention over the frames (the plain chunked attention: the flash
gate takes causal attention only); the decoder is causal self-attention
(the flash kernel at prefill with ``cfg.use_flash_kernel``), then
cross-attention to the encoder's output (chunked, Sq != Sk), then the MLP.
Positions are sinusoidal, in f32, computed on the fly. As in the
reference, the MLPs are SwiGLU (not whisper's GELU), and a decode step
recomputes every layer's cross-attention K/V from ``enc_out``: nothing
caches them.

Layers are stacked (``enc_layers``, ``dec_layers``: a leading layer axis
on every leaf), as the reference's, so ``convert.py`` maps the JAX params
one to one; a Python loop runs the layers (the reference's
``unroll_layers`` is an XLA loop control and changes no result).

Given block leaves (the sharded steps' tensor-parallel route), the
attentions run a model shard's heads each (the cross-attention through
``_cross_attend_split``), the MLPs its columns, and the embedding and head
are vocab-parallel (``models/transformer``'s helpers); the self-attention
cache is then one tensor a model shard and ``enc_out`` stays whole on the
first device.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch import obs
from repro_torch.configs import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_cache_layer, _embed_rows, _head_logits, _logz_gold,
                                            _stack_layers, _unstack)

Params = Dict[str, Any]


def sinusoid_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions (...,) -> (..., d) f32: sin of the angles, then cos.

    The frequencies' exponent is arange(half) * (-ln(10000) * (1 / half)),
    each factor an f32, as the jitted reference folds its
    ``-log(10000) * arange(half) / half``; only ``exp``'s last bit then
    differs, an angle error under 2.5e-5 at position 2,079."""
    half = d // 2
    f32 = dict(dtype=torch.float32, device=positions.device)
    coef = -torch.tensor(math.log(10000.0), **f32) * torch.reciprocal(
        torch.tensor(float(half), **f32))
    freqs = torch.exp(torch.arange(half, **f32) * coef)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_whisper(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    """Random weights from ``gen`` (on ``device``) in ``cfg.param_dtype``;
    the norms ones."""
    dtype = L.dtype_of(cfg.param_dtype)
    d, ne, nd = cfg.d_model, cfg.encoder_layers, cfg.n_layers
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)  # noqa: E731
    return {
        # the frontend stub's projector (frames arrive embedded at frontend_dim)
        "frame_proj": L.dense_init(gen, (cfg.frontend_dim, d), dtype, device),
        "enc_layers": {
            "attn_norm": ones(ne, d),
            "mlp_norm": ones(ne, d),
            "attn": L.init_attention(gen, cfg, dtype, device, lead=(ne,)),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, dtype, device, lead=(ne,)),
        },
        "enc_norm": ones(d),
        "embed": L.embed_init(gen, (cfg.vocab_size, d), dtype, device),
        "dec_layers": {
            "self_norm": ones(nd, d),
            "cross_norm": ones(nd, d),
            "mlp_norm": ones(nd, d),
            "self_attn": L.init_attention(gen, cfg, dtype, device, lead=(nd,)),
            "cross_attn": L.init_attention(gen, cfg, dtype, device, lead=(nd,)),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, dtype, device, lead=(nd,)),
        },
        "final_norm": ones(d),
        "lm_head": L.dense_init(gen, (d, cfg.vocab_size), dtype, device),
    }


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def encode(params: Params, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """frames (B, T_enc, frontend_dim) -> (B, T_enc, d), non-causal."""
    x = frames.to(L.dtype_of(cfg.compute_dtype)) @ params["frame_proj"]
    B, T, _ = x.shape
    pos = _positions(B, T, x.device)
    x = x + sinusoid_pos(pos, cfg.d_model).to(x.dtype)
    for lp in _unstack(params["enc_layers"], cfg.encoder_layers):
        h, _ = L.attention_block(lp["attn"], L.rms_norm(x, lp["attn_norm"], cfg.norm_eps), cfg,
                                 pos, causal=False)
        x = x + h
        x = x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_attend(layer_p: Params, x: torch.Tensor, enc_out: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """Cross-attention: queries from the decoder's x, K/V from the
    encoder's output (recomputed at every call). Returns x plus it."""
    B, S, _ = x.shape
    xn = L.rms_norm(x, layer_p["cross_norm"], cfg.norm_eps)
    p = layer_p["cross_attn"]
    if L._is_split(p):
        return x + _cross_attend_split(p, xn, enc_out, cfg)
    Dh = cfg.resolved_head_dim()
    q = (xn @ p["wq"]).reshape(B, S, cfg.n_heads, Dh)
    k = (enc_out @ p["wk"]).reshape(B, -1, cfg.n_kv_heads, Dh)
    v = (enc_out @ p["wv"]).reshape(B, -1, cfg.n_kv_heads, Dh)
    out = L.chunked_attention(q, k, v, causal=False, q_chunk=cfg.attn_chunk,
                              k_chunk=cfg.attn_chunk)
    return x + out.reshape(B, S, -1) @ p["wo"]


def _cross_attend_split(p: Params, xn: torch.Tensor, enc_out: torch.Tensor,
                        cfg: ArchConfig) -> torch.Tensor:
    """The cross-attention over M model shards (H / M query heads each):
    shard m's queries through its ``wq`` block, its kv heads from a copy of
    ``enc_out`` through its ``wk``/``wv`` blocks (or every kv head through
    the whole leaves, ``layers._kv_heads``), the chunked attention on its
    heads and its ``wo`` row block: f32 partials that ``layers._row_sum``
    adds in shard order on xn's device."""
    B, S, d = xn.shape
    home = xn.device
    devices, Hl, G, wq, wo, wk, wv, kv_split, _ = L._split_leaves(p, cfg, home)
    Dh = cfg.resolved_head_dim()
    partials = []
    with obs.span("tensor_parallel", kind="cross_attn", mp=len(devices),
                  partial_bytes=len(devices) * B * S * d * 4):
        for m, dev in enumerate(devices):
            e = enc_out.to(dev)
            q = (xn.to(dev) @ wq[m]).reshape(B, S, Hl, Dh)
            k = (e @ (wk[m] if kv_split else wk.to(dev))).reshape(B, e.shape[1], -1, Dh)
            v = (e @ (wv[m] if kv_split else wv.to(dev))).reshape(B, e.shape[1], -1, Dh)
            if not kv_split:
                k, v = (L._kv_heads(t, m, Hl, G).contiguous() for t in (k, v))
            o = L.chunked_attention(q, k, v, causal=False, q_chunk=cfg.attn_chunk,
                                    k_chunk=cfg.attn_chunk)
            partials.append(L._F32Product.apply(o.reshape(B, S, Hl * Dh), wo[m]))
        return L._row_sum(partials, home, xn.dtype)


def decoder_forward(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
                    cfg: ArchConfig, differentiable: bool = True):
    """Final-norm hidden states (B, S, d) and each layer's self-attention
    (k, v)."""
    x = _embed_rows(params["embed"], tokens).to(L.dtype_of(cfg.compute_dtype))
    B, S = tokens.shape
    pos = _positions(B, S, x.device)
    x = x + sinusoid_pos(pos, cfg.d_model).to(x.dtype)
    kvs = []
    for lp in _unstack(params["dec_layers"], cfg.n_layers):
        h, kv = L.attention_block(lp["self_attn"], L.rms_norm(x, lp["self_norm"], cfg.norm_eps),
                                  cfg, pos, causal=True, differentiable=differentiable)
        x = x + h
        x = _cross_attend(lp, x, enc_out, cfg)
        x = x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
        kvs.append(kv)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), kvs


def whisper_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Next-token CE over the decoder's tokens (full logits, as the
    reference). batch: {"frames": (B, T_enc, F), "tokens": (B, S)}."""
    enc_out = encode(params, batch["frames"], cfg)
    x, _ = decoder_forward(params, batch["tokens"], enc_out, cfg)
    targets = batch["tokens"][:, 1:].long()
    logz, gold = _logz_gold(x[:, :-1], params["lm_head"], targets, from_logits=True)
    loss = (logz - gold).mean()
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=x.device)}


def whisper_prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Encode the frames and run the decoder over the prompt. Returns
    (last-position logits (B, V) f32, cache {"k", "v": (nl, B, S, KV, Dh),
    "pos": (nl, B, S) int32, "enc_out": (B, T_enc, d)})."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    with torch.no_grad():
        enc_out = encode(params, batch["frames"], cfg)
        x, kvs = decoder_forward(params, tokens, enc_out, cfg, differentiable=False)
        logits = _head_logits(params, x[:, -1], cfg)
        cache = {
            "k": _stack_layers([k for k, _ in kvs]),
            "v": _stack_layers([v for _, v in kvs]),
            "pos": torch.arange(S, dtype=torch.int32, device=x.device).expand(
                cfg.n_layers, B, S).contiguous(),
            "enc_out": enc_out,
        }
    return logits, cache


def init_whisper_cache(cfg: ArchConfig, B: int, cache_len: int, device) -> Params:
    """Empty KV slots (positions -1) and an all-zero ``enc_out``: the
    encoder's output is decode state that only a prefill writes."""
    dt = L.dtype_of(cfg.param_dtype)
    nl, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim()
    return {
        "k": torch.zeros((nl, B, cache_len, KV, Dh), dtype=dt, device=device),
        "v": torch.zeros((nl, B, cache_len, KV, Dh), dtype=dt, device=device),
        "pos": torch.full((nl, B, cache_len), -1, dtype=torch.int32, device=device),
        "enc_out": torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=dt, device=device),
    }


def whisper_decode_step(params: Params, cache: Params, batch: Dict[str, torch.Tensor],
                        cfg: ArchConfig, *, window: int = 0):
    """One token. batch = {"tokens": (B, 1), "pos": (B,)}. Returns (logits
    (B, V) f32, cache); the K/V/pos tensors are updated in place and
    ``enc_out`` is read as it is."""
    with torch.no_grad():
        x = _embed_rows(params["embed"], batch["tokens"]).to(L.dtype_of(cfg.compute_dtype))
        pos = batch["pos"].long()
        x = x + sinusoid_pos(pos[:, None], cfg.d_model).to(x.dtype)
        enc_out = cache["enc_out"]
        for i, lp in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
            h, _ = L.attention_decode_block(
                lp["self_attn"], L.rms_norm(x, lp["self_norm"], cfg.norm_eps), cfg, pos,
                {name: _cache_layer(cache[name], i) for name in ("k", "v", "pos")},
                window=window,
            )
            x = x + h
            x = _cross_attend(lp, x, enc_out, cfg)
            x = x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = _head_logits(params, x[:, 0], cfg)
    return logits, cache
