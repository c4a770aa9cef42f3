"""Zamba2-style hybrid of the port (the JAX package's ``models/hybrid.py``):
a Mamba-2 backbone and one *shared* attention block.

The shared block (attention, then a SwiGLU MLP, the same weights at every
application) runs after every ``attn_every`` Mamba-2 layers and reads
``concat([hidden, embedding]) @ in_proj``, the embedding being the token
embeddings the model started from. The Mamba-2 params are stacked
``(n_seg, every, ...)``, as the reference's, so ``convert.py`` maps them
one to one; a Python loop runs the segments and each segment's layers
(the reference's ``unroll_layers`` is an XLA loop control and changes no
result). With ``cfg.use_flash_kernel`` the prefill's shared attention
goes through the flash kernel, once a segment. Given block leaves (the
sharded steps' tensor-parallel route), the Mamba-2 layers run a model
shard's heads each (``models/ssm``), the shared block its attention heads
and MLP columns (``models/layers``), and the embedding and head are
vocab-parallel (``models/transformer``'s helpers); the caches' leaves are
then lists of each model shard's.

Simplifications of the reference kept here: a single shared block (Zamba2
alternates two) and no per-application LoRA.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import (_cache_layer, _embed_rows, _head_logits, _logz_gold,
                                            _stack_layers, _unstack)

Params = Dict[str, Any]


def _segments(cfg: ArchConfig) -> Tuple[int, int]:
    every = cfg.attn_every or cfg.n_layers
    n_seg = max(1, cfg.n_layers // every)
    return n_seg, every


def init_hybrid(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    """Random weights from ``gen`` (on ``device``) in ``cfg.param_dtype``;
    the Mamba-2 blocks' ``A_log``, ``D`` and ``dt_bias`` in f32."""
    dtype = L.dtype_of(cfg.param_dtype)
    n_seg, every = _segments(cfg)
    d = cfg.d_model
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)  # noqa: E731
    return {
        "embed": L.embed_init(gen, (cfg.vocab_size, d), dtype, device),
        "segments": {"norm": ones(n_seg, every, d),
                     "mamba": S.init_mamba2(gen, cfg, dtype, device, lead=(n_seg, every))},
        "shared": {
            "attn_norm": ones(d),
            "mlp_norm": ones(d),
            "attn": L.init_attention(gen, cfg, dtype, device),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, dtype, device),
            # the projection of the shared block's concat([hidden, embedding])
            "in_proj": L.dense_init(gen, (2 * d, d), dtype, device),
        },
        "final_norm": ones(d),
        "lm_head": L.dense_init(gen, (d, cfg.vocab_size), dtype, device),
    }


def _layers(segments: Params, n_seg: int, every: int):
    """The stacked (n_seg, every, ...) Mamba-2 layers as n_seg lists of
    ``every`` per-layer trees (each leaf unbound on both axes)."""
    return [_unstack(seg, every) for seg in _unstack(segments, n_seg)]


def _shared_attn(shared: Params, x: torch.Tensor, x0: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, differentiable: bool = True):
    """The weight-shared attention block. x0 = the token embeddings."""
    inp = torch.cat([x, x0], dim=-1) @ shared["in_proj"]
    h, kv = L.attention_block(
        shared["attn"], L.rms_norm(inp, shared["attn_norm"], cfg.norm_eps), cfg, positions,
        causal=True, differentiable=differentiable,
    )
    x = x + h
    x = x + L.mlp_block(shared["mlp"], L.rms_norm(x, shared["mlp_norm"], cfg.norm_eps))
    return x, kv


def _forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig, collect_state: bool,
             differentiable: bool = True):
    """Final-norm hidden states (B, T, d) and, with ``collect_state``, per
    segment (its layers' Mamba-2 states, the shared block's (k, v))."""
    x = _embed_rows(params["embed"], tokens).to(L.dtype_of(cfg.compute_dtype))
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    x0 = x

    def inner(xc, layer_p):
        xn = L.rms_norm(xc, layer_p["norm"], cfg.norm_eps)
        out, state = S.mamba2_block(layer_p["mamba"], xn, cfg, return_state=collect_state)
        return xc + out, state

    # remat wraps the Mamba-2 layers only, as the reference's
    remat = cfg.remat and torch.is_grad_enabled() and not collect_state
    n_seg, every = _segments(cfg)
    collected = []
    for seg in _layers(params["segments"], n_seg, every):
        states = []
        for layer_p in seg:
            if remat:
                # the block draws no random numbers: no RNG state to replay
                x = checkpoint(lambda xc, lp: inner(xc, lp)[0], x, layer_p,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x, st = inner(x, layer_p)
                states.append(st)
        x, kv = _shared_attn(params["shared"], x, x0, cfg, positions,
                             differentiable=differentiable)
        if collect_state:
            collected.append((states, kv))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, (collected if collect_state else None)


def hybrid_prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Full forward; returns (last-position logits (B, V) f32, cache
    {"ssm_h": (n_seg, every, B, H, P, N) f32, "ssm_conv": (n_seg, every,
    B, K - 1, conv_dim), "k", "v": (n_seg, B, T, KV, Dh), "pos": (n_seg,
    B, T) int32})."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    with torch.no_grad():
        x, collected = _forward(params, tokens, cfg, collect_state=True, differentiable=False)
        logits = _head_logits(params, x[:, -1], cfg)
        cache = {
            "ssm_h": _stack_layers([_stack_layers([st["h"] for st in states])
                                    for states, _ in collected]),
            "ssm_conv": _stack_layers([_stack_layers([st["conv"] for st in states])
                                       for states, _ in collected]),
            "k": _stack_layers([kv[0] for _, kv in collected]),
            "v": _stack_layers([kv[1] for _, kv in collected]),
            "pos": torch.arange(T, dtype=torch.int32, device=x.device).expand(
                len(collected), B, T).contiguous(),
        }
    return logits, cache


def hybrid_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Next-token CE over every position (full logits, as the reference;
    vocab-parallel for a split head)."""
    tokens = batch["tokens"]
    x, _ = _forward(params, tokens, cfg, collect_state=False)
    logz, gold = _logz_gold(x[:, :-1], params["lm_head"], tokens[:, 1:].long(), from_logits=True)
    loss = (logz - gold).mean()
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=x.device)}


def init_hybrid_cache(cfg: ArchConfig, B: int, cache_len: int, device) -> Params:
    dt = L.dtype_of(cfg.param_dtype)
    n_seg, every = _segments(cfg)
    di, H, N = cfg.resolved_d_inner(), cfg.resolved_ssm_heads(), cfg.ssm_state
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim()
    conv_dim = di + 2 * N
    return {
        "ssm_h": torch.zeros((n_seg, every, B, H, di // H, N), dtype=torch.float32,
                             device=device),
        "ssm_conv": torch.zeros((n_seg, every, B, cfg.ssm_conv - 1, conv_dim), dtype=dt,
                                device=device),
        "k": torch.zeros((n_seg, B, cache_len, KV, Dh), dtype=dt, device=device),
        "v": torch.zeros((n_seg, B, cache_len, KV, Dh), dtype=dt, device=device),
        "pos": torch.full((n_seg, B, cache_len), -1, dtype=torch.int32, device=device),
    }


def hybrid_decode_step(params: Params, cache: Params, batch: Dict[str, torch.Tensor],
                       cfg: ArchConfig, *, window: int = 0):
    """One token. batch = {"tokens": (B, 1), "pos": (B,)}. Returns (logits
    (B, V) f32, cache); the cache tensors are updated in place. The shared
    block reads the token's own embedding beside the hidden state."""
    with torch.no_grad():
        x = _embed_rows(params["embed"], batch["tokens"]).to(L.dtype_of(cfg.compute_dtype))
        pos = batch["pos"].long()
        x0 = x
        n_seg, every = _segments(cfg)
        shared = params["shared"]
        for s, seg in enumerate(_layers(params["segments"], n_seg, every)):
            for i, layer_p in enumerate(seg):
                xn = L.rms_norm(x, layer_p["norm"], cfg.norm_eps)
                state = {"h": _cache_layer(_cache_layer(cache["ssm_h"], s), i),
                         "conv": _cache_layer(_cache_layer(cache["ssm_conv"], s), i)}
                out, new = S.mamba2_decode(layer_p["mamba"], xn, cfg, state)
                x = x + out
                if new is not state:  # a split block wrote each shard's state in place
                    state["h"].copy_(new["h"])
                    state["conv"].copy_(new["conv"])
            inp = torch.cat([x, x0], dim=-1) @ shared["in_proj"]
            h, _ = L.attention_decode_block(
                shared["attn"], L.rms_norm(inp, shared["attn_norm"], cfg.norm_eps), cfg, pos,
                {name: _cache_layer(cache[name], s) for name in ("k", "v", "pos")},
                window=window,
            )
            x = x + h
            x = x + L.mlp_block(shared["mlp"], L.rms_norm(x, shared["mlp_norm"], cfg.norm_eps))
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = _head_logits(params, x[:, 0], cfg)
    return logits, cache
