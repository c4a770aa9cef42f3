"""Optimizers over parameter trees (the JAX package's
``optim/optimizers.py``): the learning-rate schedules, ``sgd``,
``momentum``, ``adam``/``adamw`` with optionally quantized resident
state, ``clip_by_global_norm`` and ``state_nbytes``.

An ``Optimizer`` is an (init, update) pair:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)

``step`` is the train state's 0-d int32 tensor (a Python int for the
FL client's constant rate). Schedules return a 0-d f32 tensor on the
step's device. Every division here is a division of
two tensors on one device: PyTorch evaluates a Python float over a tensor
as a multiply by the tensor's reciprocal, and on CUDA a tensor over a
Python float as a multiply by the float's reciprocal, where the reference
divides.

With ``quantize=True`` the moments are stored compressed: the first in
bf16, Adam's second blockwise-int8 in the sqrt domain
(``core/quant.quantize_state``) with a half-step floor on the update's
denominator (see ``_adam_impl``). Updates are computed leaf by leaf, so
at most one leaf's f32 temporaries are alive at a time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

from repro_torch.core import quant
from repro_torch.core.quant import _f32
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[..., Tuple[Tree, Tree]]  # (grads, state, params, step)


# ---------------------------------------------------------------- schedules


def constant_schedule(lr: float) -> Schedule:
    return lambda step: _f32(lr, step)


def cosine_schedule(lr: float, total_steps: int, min_frac: float = 0.1) -> Schedule:
    def fn(step):
        t = torch.clamp(step.to(torch.float32) / _f32(max(total_steps, 1), step), 0.0, 1.0)
        return lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t)))

    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1) -> Schedule:
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), min_frac)

    def fn(step):
        ratio = step.to(torch.float32) / _f32(max(warmup, 1), step)
        warm = lr * torch.clamp_max(ratio, 1.0)
        return torch.where(step < warmup, warm, cos(step - warmup))

    return fn


def _as_schedule(lr) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


# ------------------------------------------------------- gradient transforms


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor ``clip_by_global_norm`` scales every gradient by."""
    return torch.clamp_max(_f32(max_norm, norm) / torch.clamp_min(norm, 1e-12), 1.0)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    norm = torch.sqrt(sum((g.to(torch.float32).square().sum() for g in tree_leaves(grads))))
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def state_nbytes(state: Tree) -> int:
    """Resident bytes of a state tree (leaf bytes summed)."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(state)))


def _grid_half_step(scale: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Half the int8 grid step, broadcast to ``leaf``'s shape per block."""
    cols = torch.atleast_1d(scale).repeat_interleave(quant.STATE_BLOCK)[: leaf.numel()]
    return (cols / _f32(2.0, cols)).reshape(leaf.shape)


# ---------------------------------------------------------------- optimizers


def sgd(lr) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {}

    def update(grads, state, params, step):
        lr_t = sched(step)
        return tree_map(lambda g: -lr_t * g.to(torch.float32), grads), state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, *, quantize: bool = False) -> Optimizer:
    """Heavy-ball momentum; ``quantize=True`` stores the velocity bf16."""
    sched = _as_schedule(lr)
    store_dtype = torch.bfloat16 if quantize else torch.float32

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=store_dtype), params)}

    def update(grads, state, params, step):
        lr_t = sched(step)
        m = tree_map(lambda m_, g: beta * m_.to(torch.float32) + g.to(torch.float32),
                     state["m"], grads)
        updates = tree_map(lambda m_: -lr_t * m_, m)
        return updates, {"m": tree_map(lambda m_: m_.to(store_dtype), m)}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, *,
         quantize: bool = False) -> Optimizer:
    return _adam_impl(lr, b1, b2, eps, weight_decay=0.0, quantize=quantize)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01, *, quantize: bool = False) -> Optimizer:
    return _adam_impl(lr, b1, b2, eps, weight_decay=weight_decay, quantize=quantize)


def _adam_impl(lr, b1, b2, eps, weight_decay, quantize: bool = False) -> Optimizer:
    """Adam/AdamW. ``quantize=True`` stores m bf16 and v blockwise-int8.

    The second moment is stored in the sqrt domain (``v_q`` holds sqrt(v)
    on the int8 amax grid) and the update's denominator is floored at the
    grid's half-step, as in the reference: a linear grid on v collapses
    small second moments in outlier-heavy blocks to 0, and a zero
    denominator turns the next step into mh/eps. The recurrences and bias
    correction are the standard math on the dequantized f32 values.
    """
    sched = _as_schedule(lr)

    def init(params):
        if not quantize:
            return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
                    "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}
        pairs = [quant.quantize_state(torch.zeros_like(p, dtype=torch.float32))
                 for p in tree_leaves(params)]
        structure = tree_flatten(params)[1]
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.bfloat16), params),
                "v_q": tree_unflatten(structure, [q for q, _ in pairs]),
                "v_scale": tree_unflatten(structure, [s for _, s in pairs])}

    def update(grads, state, params, step):
        t = step.to(torch.float32) + 1.0
        lr_t = sched(step)
        c1 = 1 - b1**t
        c2 = 1 - b2**t
        bc2 = torch.sqrt(c2)
        g_leaves, structure = tree_flatten(grads)
        p_leaves = tree_leaves(params)
        if quantize:
            prev = zip(tree_leaves(state["m"]), tree_leaves(state["v_q"]),
                       tree_leaves(state["v_scale"]))
        else:
            prev = zip(tree_leaves(state["m"]), tree_leaves(state["v"]))
        outs = []
        for g, p, pv in zip(g_leaves, p_leaves, prev):
            g = g.to(torch.float32)
            if quantize:
                m_prev = pv[0].to(torch.float32)
                v_prev = quant.dequantize_state(pv[1], pv[2]).square()
            else:
                m_prev, v_prev = pv
            m = b1 * m_prev + (1 - b1) * g
            v = b2 * v_prev + (1 - b2) * g.square()
            mh = m / c1
            if quantize:
                r = torch.sqrt(v)
                v_q, v_scale = quant.quantize_state(r)
                denom = torch.maximum(r, _grid_half_step(v_scale, r)) / bc2 + eps
                new = (m.to(torch.bfloat16), v_q, v_scale)
            else:
                denom = torch.sqrt(v / c2) + eps
                new = (m, v)
            u = -lr_t * mh / denom
            if weight_decay:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            outs.append((u, new))
        updates = tree_unflatten(structure, [u for u, _ in outs])
        names = ("m", "v_q", "v_scale") if quantize else ("m", "v")
        return updates, {name: tree_unflatten(structure, [new[i] for _, new in outs])
                         for i, name in enumerate(names)}

    return Optimizer(init, update)
