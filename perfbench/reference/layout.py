"""A parameter tree's leaves: shape, stored dtype, how the benchmark
draws it, and how many leading axes stack layers (each slice of them is
one unit of the comparison)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    dtype: str  # "bfloat16" | "float32" | ...
    init: str  # "dense" | "embed" | "ones" | "zeros" | "conv" | "a_log" | "dt_bias"
    stack: int = 0


def leaves(tree, prefix=""):
    """(dotted name, leaf) of a nested dict, keys in sorted order."""
    out = []
    for k in sorted(tree):
        name = f"{prefix}.{k}" if prefix else k
        v = tree[k]
        out += leaves(v, name) if isinstance(v, dict) else [(name, v)]
    return out
