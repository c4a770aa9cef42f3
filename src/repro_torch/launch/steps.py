"""Step functions (the JAX package's ``launch/steps.py``): the train
state, the training step and the client's quantized local training step,
with PyTorch autograd, and the serving path's prefill and decode steps.

A train state is ``{"params", "opt", "step"}``, ``step`` a 0-d int32
tensor on the params' device, as the reference's, so a checkpoint of it
loads in either package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.core import quant
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models.registry import Model
from repro_torch.optim import Optimizer, clip_by_global_norm


def init_train_state(model: Model, opt: Optimizer, generator: torch.Generator) -> Dict[str, Any]:
    """Random params from ``generator``, on the generator's device."""
    params = model.init(generator, generator.device)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=generator.device)}


def train_state_shapes(model: Model, opt: Optimizer) -> Dict[str, Any]:
    """The train state's shapes and dtypes as meta tensors (no allocation,
    no random draws)."""
    meta = torch.device("meta")
    params = model.init(None, meta)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=meta)}


def _value_and_grad(model: Model, params: Any, batch: Dict[str, torch.Tensor], transform=None):
    """(loss, metrics, grads, detached params) of ``model.loss`` at
    ``params``; ``transform`` maps the live params before the forward. A
    param the loss does not reach (the vlm projector on a batch without
    patches) gets a zero gradient, as from ``jax.grad``."""
    leaves, structure = tree_flatten(params)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    tree = tree_unflatten(structure, live)
    loss, metrics = model.loss(tree if transform is None else transform(tree), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = tree_unflatten(structure, [torch.zeros_like(p) if g is None else g
                                       for p, g in zip(live, grads)])
    return loss.detach(), metrics, grads, tree_unflatten(structure, [p.detach() for p in live])


def _apply(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype), params, updates)


def make_train_step(model: Model, opt: Optimizer, *, clip_norm: float = 1.0) -> Callable:
    """One step: loss and gradients, global-norm clip, the optimizer, the
    update added in f32 and cast back to each param's dtype."""

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        loss, metrics, grads, params = _value_and_grad(model, state["params"], batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = opt.update(grads, state["opt"], params, state["step"])
        del grads
        new_state = {"params": _apply(params, updates), "opt": opt_state,
                     "step": state["step"] + 1}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return new_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


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
        loss, metrics, grads, params = _value_and_grad(
            model, state["params"], batch,
            lambda tree: tree_map(
                lambda p: quant.ste_fake_quant(p, bits) if p.dim() >= 2 else p, tree))
        if fedprox_mu > 0.0 and "anchor" in state:
            grads = tree_map(
                lambda g, p, a: g + (fedprox_mu * (
                    p.to(torch.float32) - a.to(torch.float32))).to(g.dtype),
                grads, params, state["anchor"],
            )
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = opt.update(grads, state["opt"], params, state["step"])
        new_state = {"params": _apply(params, updates), "opt": opt_state,
                     "step": state["step"] + 1}
        if "anchor" in state:
            new_state["anchor"] = state["anchor"]
        return new_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(model: Model, *, window: int = 0) -> Callable:
    def decode_step(params, cache, batch):
        return model.decode(params, cache, batch, window=window)

    return decode_step
