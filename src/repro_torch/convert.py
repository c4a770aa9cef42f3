"""Weights across the package boundary: nested dict/list trees of numpy
arrays (the JAX package's params, moved to the host) <-> the port's trees
of tensors, in the same structure and layouts."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import tree_map

Tree = Any


def params_from_numpy(tree: Tree, device) -> Tree:
    """numpy leaves -> tensors on ``device`` (dtype kept)."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree
    )


def params_to_numpy(params: Tree) -> Tree:
    """tensor leaves -> numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
