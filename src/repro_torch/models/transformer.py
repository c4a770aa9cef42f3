"""Decoder-only LM of the dense family (the JAX package's
``models/transformer.py``, dense family only).

Layers are *stacked*: every per-layer param has a leading ``n_layers``
axis, as in the reference, so ``convert.py`` maps the JAX params one to
one. The reference scans the stack; here a Python loop indexes it.

Entry points:
- ``prefill(params, batch, cfg)``        full-sequence forward + KV cache.
- ``decode_step(params, cache, batch, cfg)``  one token against the cache.
- ``init_decode_cache(cfg, B, cache_len, device)``.
``lm_loss`` (training) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


# ------------------------------------------------------------------------ init


def _init_layers(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device) -> Params:
    """Every layer's params, stacked on a leading ``n_layers`` axis."""
    nl, d = cfg.n_layers, cfg.d_model
    return {
        "attn_norm": torch.ones((nl, d), dtype=dtype, device=device),
        "mlp_norm": torch.ones((nl, d), dtype=dtype, device=device),
        "attn": L.init_attention(gen, cfg, dtype, device, lead=(nl,)),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, dtype, device, lead=(nl,)),
    }


def init_lm(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    """Random weights from ``gen`` (on ``device``) in ``cfg.param_dtype``."""
    dtype = L.dtype_of(cfg.param_dtype)
    p: Params = {
        "embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device),
        "layers": _init_layers(gen, cfg, dtype, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device)
    return p


def _layer(stacked: Any, i: int) -> Any:
    """Layer ``i``'s params (views) out of the stacked tree."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


# ---------------------------------------------------------------------- blocks


def _block(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
           window: int, differentiable: bool = True):
    """Full-sequence layer. Returns (x, (k, v))."""
    h, kv = L.attention_block(
        p["attn"], L.rms_norm(x, p["attn_norm"], cfg.norm_eps), cfg, positions,
        causal=True, window=window, differentiable=differentiable,
    )
    x = x + h
    hn = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + L.mlp_block(p["mlp"], hn), kv


def _block_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor,
                  cache: Dict[str, torch.Tensor], window: int):
    h, new_cache = L.attention_decode_block(
        p["attn"], L.rms_norm(x, p["attn_norm"], cfg.norm_eps), cfg, pos, cache,
        window=window,
    )
    x = x + h
    hn = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + L.mlp_block(p["mlp"], hn), new_cache


# --------------------------------------------------------- embeddings / positions


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None, :].expand(B, S)


def _embed_inputs(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """tokens -> (B, S, d) in the compute dtype."""
    x = params["embed"][batch["tokens"].long()]
    return x.to(L.dtype_of(cfg.compute_dtype))


def _head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# --------------------------------------------------------------------- forward


def _run_layers(params: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                window: int, collect_kv: bool = False, differentiable: bool = True):
    """Apply the stacked layers in order. Returns (x, [(k, v)] | None)."""
    kvs = [] if collect_kv else None
    for i in range(cfg.n_layers):
        x, kv = _block(_layer(params["layers"], i), x, cfg, positions, window,
                       differentiable)
        if collect_kv:
            kvs.append(kv)
    return x, kvs


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Full forward; returns (last-position logits (B, V) f32, primed KV
    cache {"k", "v": (nl, B, S, KV, Dh), "pos": (nl, B, S) int32})."""
    with torch.no_grad():
        x = _embed_inputs(params, batch, cfg)
        B, S = x.shape[:2]
        positions = _positions(B, S, x.device)
        x, kvs = _run_layers(params, x, cfg, positions, window=0, collect_kv=True,
                             differentiable=False)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = (x[:, -1] @ _head(params, cfg)).to(torch.float32)
        cache = {
            "k": torch.stack([k for k, _ in kvs]),
            "v": torch.stack([v for _, v in kvs]),
            "pos": _positions(B, S, x.device)[None].expand(cfg.n_layers, B, S).contiguous(),
        }
    return logits, cache


def init_decode_cache(cfg: ArchConfig, B: int, cache_len: int, device) -> Params:
    """Per-layer KV cache stacked on the layer axis; positions -1 = empty."""
    dt = L.dtype_of(cfg.param_dtype)
    nl, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim()
    return {
        "k": torch.zeros((nl, B, cache_len, KV, Dh), dtype=dt, device=device),
        "v": torch.zeros((nl, B, cache_len, KV, Dh), dtype=dt, device=device),
        "pos": torch.full((nl, B, cache_len), -1, dtype=torch.int32, device=device),
    }


def decode_step(params: Params, cache: Params, batch: Dict[str, torch.Tensor],
                cfg: ArchConfig, *, window: int = 0):
    """One token. batch = {"tokens": (B, 1), "pos": (B,)}. Returns (logits
    (B, V) f32, cache); the cache tensors are updated in place."""
    with torch.no_grad():
        x = params["embed"][batch["tokens"].long()].to(L.dtype_of(cfg.compute_dtype))
        pos = batch["pos"].long()
        for i in range(cfg.n_layers):
            layer_cache = {name: t[i] for name, t in cache.items()}
            x, _ = _block_decode(_layer(params["layers"], i), x, cfg, pos, layer_cache,
                                 window)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = (x[:, 0] @ _head(params, cfg)).to(torch.float32)
    return logits, cache
