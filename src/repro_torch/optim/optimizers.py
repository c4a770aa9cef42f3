"""Optimizers over parameter trees (the JAX package's
``optim/optimizers.py``: ``sgd``, ``clip_by_global_norm``,
``state_nbytes``).

An ``Optimizer`` is an (init, update) pair:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[..., Tuple[Tree, Tree]]  # (grads, state, params, step)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    norm = torch.sqrt(sum((g.to(torch.float32).square().sum() for g in tree_leaves(grads))))
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def state_nbytes(state: Tree) -> int:
    """Resident bytes of a state tree (leaf bytes summed)."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(state)))


def sgd(lr: float) -> Optimizer:
    def init(params):
        return {}

    def update(grads, state, params, step):
        return tree_map(lambda g: g.to(torch.float32) * (-lr), grads), state

    return Optimizer(init, update)
