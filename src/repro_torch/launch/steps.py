"""Step functions (the JAX package's ``launch/steps.py``): the client's
quantized local training step, with PyTorch autograd, and the serving
path's prefill and decode steps.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.core import quant
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models.registry import Model
from repro_torch.optim import Optimizer, clip_by_global_norm


def make_quantized_train_step(
    model: Model,
    opt: Optimizer,
    bits: int,
    *,
    clip_norm: float = 1.0,
    fedprox_mu: float = 0.0,
) -> Callable:
    """Local step at precision ``bits``: the forward runs on weights
    fake-quantized with straight-through gradients (leaves with
    ``ndim >= 2`` only). With ``fedprox_mu`` > 0 the proximal pull toward
    ``state["anchor"]`` is added to the gradients, then they are clipped
    to ``clip_norm``."""

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        leaves, structure = tree_flatten(state["params"])
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        params = tree_unflatten(structure, live)
        qparams = tree_map(
            lambda p: quant.ste_fake_quant(p, bits) if p.dim() >= 2 else p, params
        )
        loss, metrics = model.loss(qparams, batch)
        grads = tree_unflatten(structure, list(torch.autograd.grad(loss, live)))
        params = tree_unflatten(structure, [p.detach() for p in live])
        if fedprox_mu > 0.0 and "anchor" in state:
            grads = tree_map(
                lambda g, p, a: g + (fedprox_mu * (
                    p.to(torch.float32) - a.to(torch.float32))).to(g.dtype),
                grads, params, state["anchor"],
            )
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = opt.update(grads, state["opt"], params, state["step"])
        params = tree_map(
            lambda p, u: (p.to(torch.float32) + u).to(p.dtype), params, updates
        )
        new_state = {"params": params, "opt": opt_state, "step": state["step"] + 1}
        if "anchor" in state:
            new_state["anchor"] = state["anchor"]
        return new_state, dict(metrics, loss=loss.detach(), grad_norm=gnorm)

    return train_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(model: Model, *, window: int = 0) -> Callable:
    def decode_step(params, cache, batch):
        return model.decode(params, cache, batch, window=window)

    return decode_step
