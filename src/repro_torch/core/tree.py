"""Nested dict/list parameter trees with the JAX package's leaf order.

Params stay a nested structure of dicts, lists and tuples with tensor
leaves, flattened in ``jax.tree.flatten``'s order: dict keys sorted,
lists and tuples in order. So a flat row of the port lines up index for
index with the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def tree_flatten(tree: Tree) -> Tuple[List[Any], Any]:
    """-> (leaves, structure); ``None`` in the structure marks a leaf."""
    leaves: List[Any] = []

    def rec(t):
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(rec(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            kind = "list" if isinstance(t, list) else "tuple"
            return (kind, None, tuple(rec(c) for c in t))
        leaves.append(t)
        return None

    return leaves, rec(tree)


def tree_unflatten(structure: Any, leaves: List[Any]) -> Tree:
    it = iter(leaves)

    def rec(s):
        if s is None:
            return next(it)
        kind, keys, children = s
        built = [rec(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, built))
        return built if kind == "list" else tuple(built)

    out = rec(structure)
    assert next(it, None) is None, "more leaves than the structure holds"
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    leaves, structure = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(structure, [fn(*xs) for xs in zip(leaves, *others)])
