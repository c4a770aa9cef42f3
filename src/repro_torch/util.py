"""Small shared utilities (the JAX package's ``util.py``): the ambient
mesh, dtypes and tree sizes.

``use_mesh(mesh)`` makes a ``launch.mesh.Mesh`` the ambient mesh of a
block and ``get_abstract_mesh()`` reads it back, as in the reference: the
MoE block takes its expert-parallel path under a mesh with a ``model``
axis (``models/layers.moe_block``). The stack is the port's own; nested
blocks restore the outer mesh on exit, and the outermost clears it.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator

import torch

from repro_torch.core.tree import tree_leaves


class _EmptyMesh:
    """The ambient mesh outside any ``use_mesh`` block."""

    empty = True
    axis_names: tuple = ()
    axis_sizes: tuple = ()


_EMPTY_MESH = _EmptyMesh()

# the meshes of the open use_mesh blocks, innermost last
_MESH_STACK: list = []


def get_abstract_mesh():
    """The innermost ``use_mesh`` block's mesh, or an empty one (``.empty``
    True, no axes) outside every block."""
    return _MESH_STACK[-1] if _MESH_STACK else _EMPTY_MESH


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Make ``mesh`` the ambient mesh for the block; on exit the outer
    block's mesh is ambient again (none at the outermost level)."""
    _MESH_STACK.append(mesh)
    try:
        yield
    finally:
        _MESH_STACK.pop()


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def tree_size(tree: Any) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def count_params(params: Any) -> int:
    return tree_size(params)
