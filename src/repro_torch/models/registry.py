"""Uniform model API (the JAX package's ``models/registry.py``, family
``ds2`` only so far).

``build_model(cfg)`` returns a ``Model`` with ``init(gen, device)`` ->
params (random weights from a ``torch.Generator``) and ``loss(params,
batch)`` -> (scalar, metrics).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import ArchConfig
from repro_torch.models import deepspeech2 as DS2


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable
    loss: Callable


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "ds2":
        return Model(
            cfg=cfg,
            init=lambda gen, device: DS2.init_ds2(gen, cfg, device),
            loss=lambda p, b: DS2.ds2_loss(p, b, cfg),
        )
    raise ValueError(f"family {cfg.family!r} is not ported yet")
