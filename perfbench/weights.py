"""The initial weights both sides start from, made by the benchmark from
``--seed`` on the device: one ``torch.Generator`` a leaf, seeded from the
run's seed and the leaf's place in the tree, one draw a leaf in float32,
cast to the leaf's stored dtype. Drawing a leaf again gives the same
values on the same device, so the reference remakes them after the
program's state is freed.

Draws: ``dense`` a normal truncated at 2 sigma, scaled by fan-in^-1/2
(fan-in the second-last axis); ``embed`` normal x 0.02; ``conv`` normal
x K^-1/2; ``a_log`` log A with A log-uniform on [1, 16]; ``dt_bias`` the
inverse softplus of a step log-uniform on [1e-3, 0.1]; ``ones``,
``zeros``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.layout import Leaf, leaves


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def leaf_seed(seed: int, index: int) -> int:
    a, b = np.random.SeedSequence(int(seed), spawn_key=(index,)).generate_state(2)
    return (int(a) << 32 | int(b)) & (2**63 - 1)


def draw(leaf: Leaf, gen: torch.Generator, device) -> torch.Tensor:
    shape, kind = tuple(leaf.shape), leaf.init
    if kind in ("ones", "zeros"):
        fill = torch.ones if kind == "ones" else torch.zeros
        return fill(shape, dtype=_dtype(leaf.dtype), device=device)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if kind == "dense":
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.mul_(fan_in ** -0.5)
    elif kind == "embed":
        w.normal_(generator=gen).mul_(0.02)
    elif kind == "conv":
        w.normal_(generator=gen).mul_(shape[-2] ** -0.5)
    elif kind == "a_log":
        w.uniform_(generator=gen).mul_(math.log(16.0))
    elif kind == "dt_bias":
        lo, hi = math.log(1e-3), math.log(0.1)
        w.uniform_(generator=gen).mul_(hi - lo).add_(lo).exp_().expm1_().log_()
    else:
        raise ValueError(f"unknown draw {kind!r}")
    return w.to(_dtype(leaf.dtype))


def make(layout, seed: int, device):
    """The weights of ``layout`` (a nested dict of ``Leaf``) from ``seed``."""
    tree = {}
    for i, (name, leaf) in enumerate(leaves(layout)):
        gen = torch.Generator(device=device)
        gen.manual_seed(leaf_seed(seed, i))
        node = tree
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = draw(leaf, gen, device)
    return tree
