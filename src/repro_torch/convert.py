"""Weights across the package boundary: nested dict/list trees of numpy
arrays (the JAX package's params, moved to the host) <-> the port's trees
of tensors, in the same structure and layouts.

numpy has no bfloat16 of its own: a JAX bf16 array arrives as an array of
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses. Such leaves
cross as their raw 16-bit patterns (viewed as ``uint16``), so bf16 weights
move bit for bit in both directions; every other dtype converts as is.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import tree_map

Tree = Any


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16
        bits = np.array(a.view(np.uint16), copy=True)
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, as JAX uses it

        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Tree, device) -> Tree:
    """numpy leaves -> tensors on ``device`` (dtype kept, bf16 included)."""
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def params_to_numpy(params: Tree) -> Tree:
    """tensor leaves -> numpy arrays on the host (bf16 as ml_dtypes.bfloat16)."""
    return tree_map(_leaf_to_numpy, params)
