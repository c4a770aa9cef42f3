"""Decoder-only LM of the dense, moe, vlm and ssm families (the JAX
package's ``models/transformer.py``).

Layers are *stacked*: every per-layer param has a leading ``n_layers``
axis, as in the reference, so ``convert.py`` maps the JAX params one to
one. The reference scans the stack; here a Python loop runs the layers,
each leaf unbound once a forward (one ``stack`` in its backward, where
indexing layer by layer would allocate a whole-stack gradient per layer).
``cfg.remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``). The moe
family's blocks return the router's load-balance loss, summed over the
layers into ``lm_loss``; the vlm family prepends projected patch
embeddings (``batch["patches"]``) to the tokens and rotates q and k by
M-RoPE over (B, 3, S) positions. An ssm layer (falcon-mamba) is one
Mamba-1 block (``models/ssm.py``) behind an RMS norm: no attention, no
MLP, and a decode cache of {"h": (nl, B, d_inner, N) f32, "conv": (nl, B,
K - 1, d_inner)} that does not grow with the sequence. Given block
leaves (the sharded steps' tensor-parallel route), the embedding, the
loss's softmax and the serving head are vocab-parallel (``_embed_rows``,
``_logz_gold``, ``_head_logits``; the hybrid and whisper read them too),
and the attention's cache, or the Mamba block's states, are one tensor a
model shard (``prefill`` returns lists, ``decode_step`` takes them).

Entry points:
- ``lm_loss(params, batch, cfg)``        training loss (chunked logits).
- ``prefill(params, batch, cfg)``        full-sequence forward + KV cache.
- ``decode_step(params, cache, batch, cfg)``  one token against the cache.
- ``init_decode_cache(cfg, B, cache_len, device)``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

Params = Dict[str, Any]

LOSS_CHUNK = 512  # sequence chunk for logit materialisation (ArchConfig.loss_chunk)


# ------------------------------------------------------------------------ init


def _init_layers(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device) -> Params:
    """Every layer's params, stacked on a leading ``n_layers`` axis."""
    nl, d = cfg.n_layers, cfg.d_model
    if cfg.family == "ssm":
        return {"norm": torch.ones((nl, d), dtype=dtype, device=device),
                "mamba": S.init_mamba1(gen, cfg, dtype, device, lead=(nl,))}
    p: Params = {
        "attn_norm": torch.ones((nl, d), dtype=dtype, device=device),
        "mlp_norm": torch.ones((nl, d), dtype=dtype, device=device),
        "attn": L.init_attention(gen, cfg, dtype, device, lead=(nl,)),
    }
    if cfg.family == "moe":
        p["moe"] = L.init_moe(gen, cfg, dtype, device, lead=(nl,))
    else:
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, dtype, device, lead=(nl,))
    return p


def init_lm(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    """Random weights from ``gen`` (on ``device``) in ``cfg.param_dtype``
    (the MoE router in f32). Leaves are drawn in place a slab at a time, so
    the peak stays near the params' own bytes."""
    dtype = L.dtype_of(cfg.param_dtype)
    p: Params = {
        "embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device),
        "layers": _init_layers(gen, cfg, dtype, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device)
    if cfg.frontend == "vision":
        # projector from the stub's patch embeddings to d_model
        p["vis_proj"] = L.dense_init(gen, (cfg.frontend_dim, cfg.d_model), dtype, device)
    return p


def _layer(stacked: Any, i: int) -> Any:
    """Layer ``i``'s params (views) out of the stacked tree."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


# ---------------------------------------------------------------------- blocks


def _ffn(p: Params, hn: torch.Tensor, cfg: ArchConfig):
    """The block's feed-forward half: (out, aux), aux the MoE router's
    load-balance loss (None for the MLP, whose loss is zero)."""
    if cfg.family == "moe":
        return L.moe_block(p["moe"], hn, cfg)
    return L.mlp_block(p["mlp"], hn), None


def _block(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
           window: int, differentiable: bool = True):
    """Full-sequence layer. Returns (x, aux | None, (k, v) | None)."""
    if cfg.family == "ssm":
        x = x + S.mamba1_block(p["mamba"], L.rms_norm(x, p["norm"], cfg.norm_eps), cfg)
        return x, None, None
    h, kv = L.attention_block(
        p["attn"], L.rms_norm(x, p["attn_norm"], cfg.norm_eps), cfg, positions,
        causal=True, window=window, differentiable=differentiable,
    )
    x = x + h
    h2, aux = _ffn(p, L.rms_norm(x, p["mlp_norm"], cfg.norm_eps), cfg)
    return x + h2, aux, kv


def _block_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor,
                  cache: Dict[str, torch.Tensor], window: int):
    """One token through a layer; the layer's cache tensors are updated
    in place."""
    if cfg.family == "ssm":
        h, new_state = S.mamba1_decode(p["mamba"], L.rms_norm(x, p["norm"], cfg.norm_eps),
                                       cfg, cache)
        if new_state is not cache:  # a split block wrote each shard's state in place
            for name, t in new_state.items():
                cache[name].copy_(t)
        return x + h, cache
    h, new_cache = L.attention_decode_block(
        p["attn"], L.rms_norm(x, p["attn_norm"], cfg.norm_eps), cfg, pos, cache,
        window=window,
    )
    x = x + h
    h2, _ = _ffn(p, L.rms_norm(x, p["mlp_norm"], cfg.norm_eps), cfg)
    return x + h2, new_cache


# --------------------------------------------------------- embeddings / positions


def _positions(cfg: ArchConfig, B: int, S: int, device) -> torch.Tensor:
    """(B, S) int32; (B, 3, S) for M-RoPE, whose stub frontend gives all
    three streams the same sequential positions, as the reference's."""
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :].expand(B, S)
    if cfg.mrope:
        return pos[:, None, :].expand(B, 3, S)
    return pos


def _embed_rows(embed, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding's rows of ``tokens``. A vocab-split embedding (block
    leaf: model shard m's rows on its device, the sharded step's
    tensor-parallel route) looks up on each shard the tokens in its range
    and writes zeros elsewhere; the partials are summed on the tokens'
    device in shard order. One term a token is non-zero, so the sum is
    the whole lookup bit for bit."""
    if isinstance(embed, torch.Tensor):
        return embed[tokens.long()]
    home = tokens.device
    devices = L._split_devices(embed, home, "embed")
    x = None
    for m, block in enumerate(L._blocks(embed, -2, devices, "embed")):
        t = tokens.to(block.device).long() - m * block.shape[0]
        own = (t >= 0) & (t < block.shape[0])
        part = torch.where(own[..., None], block[torch.where(own, t, 0)],
                           torch.zeros((), dtype=block.dtype, device=block.device)).to(home)
        x = part if x is None else x + part
    return x


def _embed_inputs(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """tokens (and, for the vision frontend, the patch embeddings projected
    and prepended) -> (B, S_total, d) in the compute dtype."""
    x = _embed_rows(params["embed"], batch["tokens"])
    if cfg.frontend == "vision" and "patches" in batch:
        vis = batch["patches"].to(x.dtype) @ params["vis_proj"]
        x = torch.cat([vis, x], dim=1)
    return x.to(L.dtype_of(cfg.compute_dtype))


def _head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _head_logits(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x (B, d) through the head: (B, V) f32. A vocab-split head (block
    leaf) is vocab-parallel: each model shard's column block multiplied on
    its device, the f32 blocks joined in shard order on x's device."""
    head = _head(params, cfg)
    if isinstance(head, torch.Tensor):
        return (x @ head).to(torch.float32)
    home = x.device
    blocks = L._blocks(head, -1, L._split_devices(head, home, "lm_head"), "lm_head")
    return torch.cat([(x.to(b.device) @ b).to(torch.float32).to(home) for b in blocks], dim=-1)


# --------------------------------------------------------------------- forward


def _unstack(stacked: Any, n: int) -> List[Any]:
    """The stacked tree as ``n`` per-layer trees (each leaf unbound once)."""
    if isinstance(stacked, dict):
        per = {k: _unstack(v, n) for k, v in stacked.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(stacked.unbind(0))


def _run_layers(params: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                window: int, collect_kv: bool = False, differentiable: bool = True):
    """Apply the stacked layers in order. Returns (x, aux_total, [(k, v)] |
    None); aux sums the MoE router's loss over the layers (zero for the
    other families)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = [] if collect_kv else None
    remat = cfg.remat and torch.is_grad_enabled() and not collect_kv
    for layer_p in _unstack(params["layers"], cfg.n_layers):
        if remat:
            # the block draws no random numbers: no RNG state to replay
            x, a = checkpoint(lambda xc, lp: _block(lp, xc, cfg, positions, window,
                                                    differentiable)[:2],
                              x, layer_p, use_reentrant=False, preserve_rng_state=False)
        else:
            x, a, kv = _block(layer_p, x, cfg, positions, window, differentiable)
            if collect_kv:
                kvs.append(kv)
        if a is not None:
            aux = aux + a
    return x, aux, kvs


def lm_logits_and_aux(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Final-norm hidden states (B, S, d), the head (d, V) and aux."""
    x = _embed_inputs(params, batch, cfg)
    B, S = x.shape[:2]
    positions = _positions(cfg, B, S, x.device)
    x, aux, _ = _run_layers(params, x, cfg, positions, window=0)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, _head(params, cfg), aux


def _logz_gold(hh: torch.Tensor, head, tt: torch.Tensor, from_logits: bool = False):
    """One loss chunk's log-partition and gold logit, (B, c) f32 each:
    the logits the compute-dtype product ``hh @ head`` cast to f32, the
    gold logit the f32 dot of ``hh`` with the target's head column, or
    with ``from_logits`` the target's logit itself (the hybrid's and
    whisper's losses).

    A vocab-split head (block leaf: model shard m's columns on its device,
    the sharded step's tensor-parallel route) is the vocab-parallel CE:
    shard m's logits block stays on its device; the shards' maxima meet
    on ``hh``'s device (the global max, in shard order), each shard's sum
    of exp(logits - max) comes back and the sums are added in shard
    order; the gold logit is taken on the shard that owns the target. No
    (B, c, V) tensor crosses devices."""
    if isinstance(head, torch.Tensor):
        logits = (hh @ head).to(torch.float32)
        if from_logits:
            gold = torch.take_along_dim(logits, tt[..., None], dim=-1)[..., 0]
            return torch.logsumexp(logits, dim=-1), gold
        # gold logit = <h, head[:, target]>: gather head columns, not logits
        cols = head[:, tt.reshape(-1)].reshape(head.shape[0], *tt.shape)  # (d, B, c)
        gold = torch.einsum("bcd,dbc->bc", hh.to(torch.float32), cols.to(torch.float32))
        return torch.logsumexp(logits, dim=-1), gold
    home = hh.device
    blocks = L._blocks(head, -1, L._split_devices(head, home, "lm_head"), "lm_head")
    logits, top = [], None
    for block in blocks:
        lg = (hh.to(block.device) @ block).to(torch.float32)
        logits.append(lg)
        mx = lg.amax(dim=-1).to(home)
        top = mx if top is None else torch.maximum(top, mx)
    top = top.detach()  # logz = top + log sum exp(logits - top) for any top
    total = gold = None
    for m, (block, lg) in enumerate(zip(blocks, logits)):
        dev, V_m = block.device, block.shape[-1]
        s = torch.exp(lg - top.to(dev)[..., None]).sum(dim=-1).to(home)
        t = tt.to(dev) - m * V_m
        own = (t >= 0) & (t < V_m)
        if from_logits:
            g = torch.take_along_dim(lg, torch.where(own, t, 0)[..., None], dim=-1)[..., 0]
        else:
            cols = block[:, torch.where(own, t, 0).reshape(-1)].reshape(block.shape[0],
                                                                       *tt.shape)
            g = torch.einsum("bcd,dbc->bc", hh.to(dev).to(torch.float32),
                             cols.to(torch.float32))
        g = torch.where(own, g, torch.zeros((), device=dev)).to(home)
        total, gold = (s, g) if total is None else (total + s, gold + g)
    return top + torch.log(total), gold


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Next-token CE on the token segment; logits materialised per chunk.

    As the reference: targets are ``labels`` (else ``tokens``) shifted by
    one, weighted by ``mask``; chunks of ``min(cfg.loss_chunk, T)``
    positions, the tail zero-padded and masked out; logits are the
    compute-dtype product cast to f32, and the gold logit is the f32 dot
    of the hidden state with the gathered head column (``_logz_gold``;
    vocab-parallel for a split head).
    """
    x, head, aux = lm_logits_and_aux(params, batch, cfg)
    tokens = batch["tokens"]
    h = x[:, -tokens.shape[1]:][:, :-1]  # predict tokens[t + 1] from position t
    targets = batch.get("labels", tokens)[:, 1:].long()
    mask = batch.get("mask")
    mask = torch.ones_like(targets) if mask is None else mask[..., : targets.shape[1]]
    T = h.shape[1]
    chunk = min(cfg.loss_chunk, T)
    n = -(-T // chunk)
    pad = n * chunk - T
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n):
        hh = h[:, c * chunk:(c + 1) * chunk]
        tt = targets[:, c * chunk:(c + 1) * chunk]
        mm = mask[:, c * chunk:(c + 1) * chunk]
        logz, gold = _logz_gold(hh, head, tt)
        nll = (logz - gold) * mm
        tot = tot + nll.sum()
        cnt = cnt + mm.sum()
    loss = tot / torch.clamp_min(cnt, 1.0)
    total = loss + cfg.router_aux_coef * aux / max(cfg.n_layers, 1)
    return total, {"ce": loss, "aux": aux}


def lm_loss_count(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The count ``lm_loss`` averages its CE over (before its clamp at 1):
    the targets ``mask`` keeps, else every target."""
    targets = batch.get("labels", batch["tokens"])[:, 1:]
    mask = batch.get("mask")
    if mask is None:
        return torch.full((), float(targets.numel()), dtype=torch.float32,
                          device=targets.device)
    return mask[..., : targets.shape[1]].to(torch.float32).sum()


def lm_shards_apart(batch: Dict[str, torch.Tensor], cfg: ArchConfig) -> bool:
    """Whether ``lm_loss`` over ``batch`` under the ambient mesh is its data
    shards' losses, each under a mesh of its own data row, weighted by
    ``lm_loss_count``. Every layer computes row by row but the MoE, which
    routes each data shard apart only on its expert-parallel branch
    (``layers.moe_uses_shard_map``); off it, the whole batch's tokens share
    the ranks, the capacity and the aux loss."""
    if cfg.family != "moe":
        return True
    S = batch["tokens"].shape[1]
    if cfg.frontend == "vision" and "patches" in batch:
        S += batch["patches"].shape[1]
    return L.moe_uses_shard_map(L._mesh_info(), cfg.n_experts, cfg.experts_per_token,
                                batch["tokens"].shape[0] * S)


def _ssm_prefill(params: Params, x: torch.Tensor, cfg: ArchConfig):
    """The ssm family's prefill: the layers in order, each Mamba-1 block's
    final state and conv tail collected (each model shard's, for a split
    block). Returns (x, cache)."""
    hs, convs = [], []
    for layer_p in _unstack(params["layers"], cfg.n_layers):
        xn = L.rms_norm(x, layer_p["norm"], cfg.norm_eps)
        out, h_fin, conv_tail = S.mamba1_prefill(layer_p["mamba"], xn, cfg)
        x = x + out
        hs.append(h_fin)
        convs.append(conv_tail)
    return x, {"h": _stack_layers(hs), "conv": _stack_layers(convs)}


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Full forward; returns (last-position logits (B, V) f32, primed
    cache): for attention {"k", "v": (nl, B, S, KV, Dh), "pos": (nl, B, S)
    int32}, S counting the prepended patches too (with a split attention
    "k" and "v" are lists of each model shard's, on its device); for ssm
    {"h": (nl, B, d_inner, N) f32, "conv": (nl, B, K - 1, d_inner)}."""
    with torch.no_grad():
        x = _embed_inputs(params, batch, cfg)
        if cfg.family == "ssm":
            x, cache = _ssm_prefill(params, x, cfg)
            x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
            return _head_logits(params, x[:, -1], cfg), cache
        B, S = x.shape[:2]
        positions = _positions(cfg, B, S, x.device)
        x, _, kvs = _run_layers(params, x, cfg, positions, window=0, collect_kv=True,
                                differentiable=False)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = _head_logits(params, x[:, -1], cfg)
        cache = {
            "k": _stack_layers([k for k, _ in kvs]),
            "v": _stack_layers([v for _, v in kvs]),
            "pos": torch.arange(S, dtype=torch.int32, device=x.device).expand(
                cfg.n_layers, B, S).contiguous(),
        }
    return logits, cache


def _stack_layers(per_layer: List[Any]) -> Any:
    """Each layer's k (or v) stacked on a leading layer axis; the
    tensor-parallel attention's (a list of one tensor a model shard) as a
    list of each shard's stack, on its device."""
    if isinstance(per_layer[0], list):
        return [torch.stack([layer[m] for layer in per_layer]) for m in range(len(per_layer[0]))]
    return torch.stack(per_layer)


def _cache_layer(c: Any, i: int) -> Any:
    """Layer i's view of a cache leaf (of each model shard's, for a list)."""
    return [t[i] for t in c] if isinstance(c, list) else c[i]


def init_decode_cache(cfg: ArchConfig, B: int, cache_len: int, device) -> Params:
    """Per-layer cache stacked on the layer axis: KV with positions (-1 =
    empty), or for ssm the Mamba state and conv tail (``cache_len``
    unused)."""
    dt = L.dtype_of(cfg.param_dtype)
    if cfg.family == "ssm":
        nl, di, N, K = cfg.n_layers, cfg.resolved_d_inner(), cfg.ssm_state, cfg.ssm_conv
        return {"h": torch.zeros((nl, B, di, N), dtype=torch.float32, device=device),
                "conv": torch.zeros((nl, B, K - 1, di), dtype=dt, device=device)}
    nl, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim()
    return {
        "k": torch.zeros((nl, B, cache_len, KV, Dh), dtype=dt, device=device),
        "v": torch.zeros((nl, B, cache_len, KV, Dh), dtype=dt, device=device),
        "pos": torch.full((nl, B, cache_len), -1, dtype=torch.int32, device=device),
    }


def decode_step(params: Params, cache: Params, batch: Dict[str, torch.Tensor],
                cfg: ArchConfig, *, window: int = 0):
    """One token. batch = {"tokens": (B, 1), "pos": (B,)}. Returns (logits
    (B, V) f32, cache); the cache tensors are updated in place (with a
    split attention each leaf is a list of one tensor a model shard)."""
    with torch.no_grad():
        x = _embed_rows(params["embed"], batch["tokens"]).to(L.dtype_of(cfg.compute_dtype))
        pos = batch["pos"].long()
        for i, layer_p in enumerate(_unstack(params["layers"], cfg.n_layers)):
            layer_cache = {name: _cache_layer(t, i) for name, t in cache.items()}
            x, _ = _block_decode(layer_p, x, cfg, pos, layer_cache, window)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = _head_logits(params, x[:, 0], cfg)
    return logits, cache
