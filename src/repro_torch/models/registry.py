"""Uniform model API (the JAX package's ``models/registry.py``: families
``ds2``, ``dense``, ``moe``, ``vlm``, ``ssm``, ``hybrid`` and ``audio``).

``build_model(cfg)`` returns a ``Model`` with:
- ``init(gen, device)``                -> params (random weights from a
                                          ``torch.Generator``)
- ``loss(params, batch)``              -> (scalar, metrics)
- ``prefill(params, batch)``           -> (logits, cache)     [LMs]
- ``init_cache(B, cache_len, device)`` -> cache               [LMs]
- ``decode(params, cache, batch, window=0)`` -> (logits, cache) [LMs]
- ``input_spec(shape)``                -> dict of meta tensors (the dry run)
- ``loss_count(batch)``                -> the count ``loss`` averages over,
                                          up to a factor common to any
                                          batch of the same shape
- ``shards_apart(batch)``              -> whether ``loss`` under the ambient
                                          mesh splits over the data shards
                                          (the sharded train step)

The LM families dense, moe, vlm and ssm share ``models/transformer.py``;
hybrid has ``models/hybrid.py`` and audio ``models/whisper.py`` (its
prefill batch also holds ``frames``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs import ArchConfig, InputShape
from repro_torch.models import deepspeech2 as DS2
from repro_torch.models import hybrid as HY
from repro_torch.models import transformer as TF
from repro_torch.models import whisper as WH

# decode beyond this cache length switches to the sliding-window ring buffer
FULL_CACHE_MAX = 32_768


@dataclasses.dataclass(frozen=True)
class CacheLeaf:
    """Where a decode cache's leaf keeps its rows and slots, and what a
    decode step does to it: the one table that growing, resetting and
    writing back a cache read (every family's leaves are stacked, (L, B,
    ...) or (n_seg, every, B, ...))."""

    batch: int  # the dim of the batch rows
    slots: Optional[int] = None  # the dim of the ring's slots (pos % W); None: fixed size
    kind: str = "state"  # "slot": a step writes one slot a row; "read": never written;
    #                      "state": rewritten whole
    empty: int = 0  # an empty slot's value (padding, a slot's reset)
    # the dim a model shard's slice cuts where the tensor-parallel route
    # computes the leaf one tensor a model shard (its kv heads, channels or
    # heads; launch/steps._Units); None: never sliced
    split: Optional[int] = None


CACHE_LAYOUT = {
    "k": CacheLeaf(1, 2, "slot", split=-2), "v": CacheLeaf(1, 2, "slot", split=-2),
    "pos": CacheLeaf(1, 2, "slot", -1),
    # mamba (L, B, di, N), (L, B, K - 1, di): by channel
    "h": CacheLeaf(1, split=-2), "conv": CacheLeaf(1, split=-1),
    # the hybrid's (n_seg, every, B, H, P, N) by head, (n_seg, every, B, K - 1,
    # conv_dim) by conv channel
    "ssm_h": CacheLeaf(2, split=-3), "ssm_conv": CacheLeaf(2, split=-1),
    "enc_out": CacheLeaf(0, kind="read"),  # whisper's (B, T, D)
}


def _rows(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A loss that is a mean over every row's positions: the rows."""
    t = next(iter(batch.values()))
    return torch.full((), float(t.shape[0]), dtype=torch.float32, device=t.device)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable
    loss: Callable
    init_cache: Optional[Callable] = None
    decode: Optional[Callable] = None
    prefill: Optional[Callable] = None
    loss_count: Callable = _rows
    shards_apart: Callable = lambda batch: True

    def cache_len_for(self, seq_len: int) -> int:
        if self.cfg.family == "ssm":  # a fixed-size state, no KV slots
            return 0
        if seq_len > FULL_CACHE_MAX:
            return self.cfg.window
        return seq_len

    def decode_window_for(self, seq_len: int) -> int:
        if seq_len > FULL_CACHE_MAX:
            return self.cfg.window
        return 0

    def grow_cache(self, cache, new_len: int):
        """Pad the K/V/pos slots to ``new_len`` (e.g. after prefill, before
        decode): K/V with zeros, positions with -1 (empty). SSM state
        leaves and the encoder's ``enc_out`` are fixed-size and come back
        unchanged. A placed cache (the sharded prefill's) grows by
        ``launch.steps.grow_placed_cache``."""

        def fit(name, cur):
            ax = CACHE_LAYOUT[name].slots
            if ax is None or new_len <= cur.shape[ax]:
                return cur
            shape = list(cur.shape)
            shape[ax] = new_len - cur.shape[ax]
            fill = torch.full(shape, CACHE_LAYOUT[name].empty, dtype=cur.dtype,
                              device=cur.device)
            return torch.cat([cur, fill], dim=ax)

        return {k: fit(k, v) for k, v in cache.items()}

    def input_spec(self, shape: InputShape) -> Dict[str, torch.Tensor]:
        """Meta tensors of every model input's shape and dtype (no
        allocation), as the reference's ShapeDtypeStructs."""
        cfg = self.cfg
        B = shape.global_batch
        S = shape.seq_len
        tok = torch.int32

        def spec(shp, dtype=tok):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            if cfg.family == "audio":
                # stub frontend delivers embedded frames; tokens are targets
                return {"frames": spec((B, cfg.encoder_seq, cfg.frontend_dim), torch.bfloat16),
                        "tokens": spec((B, S))}
            if cfg.family == "ds2" and shape.kind == "train":
                return {"frames": spec((B, S, cfg.frontend_dim), torch.float32),
                        "labels": spec((B, S // 8)),
                        "frame_len": spec((B,)),
                        "label_len": spec((B,))}
            if cfg.family == "vlm":
                # stub vision frontend: 256 patch embeddings prepended
                return {"tokens": spec((B, S - 256)),
                        "patches": spec((B, 256, cfg.frontend_dim), torch.bfloat16)}
            return {"tokens": spec((B, S))}
        # decode: one new token against a cache of length seq_len
        return {"tokens": spec((B, 1)), "pos": spec((B,))}


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "ds2":
        return Model(
            cfg=cfg,
            init=lambda gen, device: DS2.init_ds2(gen, cfg, device),
            loss=lambda p, b: DS2.ds2_loss(p, b, cfg),
        )
    if cfg.family in ("dense", "moe", "vlm", "ssm"):
        return Model(
            cfg=cfg,
            init=lambda gen, device: TF.init_lm(gen, cfg, device),
            loss=lambda p, b: TF.lm_loss(p, b, cfg),
            init_cache=lambda B, n, device: TF.init_decode_cache(cfg, B, n, device),
            decode=lambda p, c, b, window=0: TF.decode_step(p, c, b, cfg, window=window),
            prefill=lambda p, b: TF.prefill(p, b, cfg),
            loss_count=TF.lm_loss_count,
            shards_apart=lambda b: TF.lm_shards_apart(b, cfg),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda gen, device: HY.init_hybrid(gen, cfg, device),
            loss=lambda p, b: HY.hybrid_loss(p, b, cfg),
            init_cache=lambda B, n, device: HY.init_hybrid_cache(cfg, B, n, device),
            decode=lambda p, c, b, window=0: HY.hybrid_decode_step(p, c, b, cfg,
                                                                   window=window),
            prefill=lambda p, b: HY.hybrid_prefill(p, b, cfg),
        )
    if cfg.family == "audio":
        return Model(
            cfg=cfg,
            init=lambda gen, device: WH.init_whisper(gen, cfg, device),
            loss=lambda p, b: WH.whisper_loss(p, b, cfg),
            init_cache=lambda B, n, device: WH.init_whisper_cache(cfg, B, n, device),
            decode=lambda p, c, b, window=0: WH.whisper_decode_step(p, c, b, cfg,
                                                                    window=window),
            prefill=lambda p, b: WH.whisper_prefill(p, b, cfg),
        )
    raise ValueError(f"unknown family {cfg.family!r}")
