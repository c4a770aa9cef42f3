"""Nested dict/list parameter trees with the JAX package's leaf order.

Params stay a nested structure of dicts, lists and tuples with tensor
leaves, flattened in ``jax.tree.flatten``'s order: dict keys sorted,
lists and tuples in order. So a flat row of the port lines up index for
index with the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def _flatten(t: Tree, leaves: List[Any]) -> Any:
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", tuple(keys), tuple(_flatten(t[k], leaves) for k in keys))
    if isinstance(t, (list, tuple)):
        kind = "list" if isinstance(t, list) else "tuple"
        return (kind, None, tuple(_flatten(c, leaves) for c in t))
    leaves.append(t)
    return None


def _unflatten(s: Any, it) -> Tree:
    if s is None:
        return next(it)
    kind, keys, children = s
    built = [_unflatten(c, it) for c in children]
    if kind == "dict":
        return dict(zip(keys, built))
    return built if kind == "list" else tuple(built)


# The recursions must stay module functions: a closure that calls itself
# is a reference cycle, which would keep the leaves list (every tensor of
# the tree, GBs of device memory for a model) alive until Python's cycle
# collector runs.


def tree_flatten(tree: Tree) -> Tuple[List[Any], Any]:
    """-> (leaves, structure); ``None`` in the structure marks a leaf."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def tree_unflatten(structure: Any, leaves: List[Any]) -> Tree:
    it = iter(leaves)
    out = _unflatten(structure, it)
    assert next(it, None) is None, "more leaves than the structure holds"
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    leaves, structure = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(structure, [fn(*xs) for xs in zip(leaves, *others)])
