"""Tree <-> flat-vector packing with a static, hashable ``Layout``, and the
packed uplink wire row (the JAX package's ``core/packing.py``).

Every client's update tree is raveled into one padded f32 vector, so the
round's aggregation works on flat rows. The layout is derived once per
tree structure and pads the total length up to a multiple of ``block``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.configs import QUANT_BLOCK
from repro_torch.core.tree import tree_flatten, tree_unflatten

Tree = Any

# lane-pad granularity of the flat layout (the reference's kernel tile
# width); the CUDA kernels mask their ragged edge and do not need it
DEFAULT_BLOCK = 2048

__all__ = [
    "DEFAULT_BLOCK",
    "KIND_RANK",
    "Layout",
    "PackedRow",
    "QUANT_BLOCK",
    "is_packed_rows",
    "make_layout",
    "n_scale_blocks",
    "pack",
    "pack_batch",
    "row_wire_bytes",
    "unpack",
    "wire_kind",
]

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
}


@dataclasses.dataclass(frozen=True)
class Layout:
    """Static description of a tree's flat packing."""

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    size: int
    padded_size: int
    block: int

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    @property
    def padding(self) -> int:
        return self.padded_size - self.size


def wire_kind(bits: int) -> str:
    """"int4"|"int8"|"int16"|"int32"|"float32" for a b-bit uplink row.

    bits <= 1 (an empty symmetric grid) and bits >= 32 ride unquantized.
    """
    if bits <= 1 or bits >= 32:
        return "float32"
    if bits <= 4:
        return "int4"
    if bits <= 8:
        return "int8"
    if bits <= 16:
        return "int16"
    return "int32"


# the aggregation groups cohort rows in this order (densest first)
KIND_RANK = {"int4": 0, "int8": 1, "int16": 2, "int32": 3, "float32": 4}


def n_scale_blocks(block: int, padded_size: int) -> int:
    """Scales a blockwise row ships: ceil(M / block); 1 when per-row."""
    if block <= 0 or block >= padded_size:
        return 1
    return -(-padded_size // block)


def row_wire_bytes(bits: int, padded_size: int, block: int = 0) -> int:
    """Bytes one client's packed row occupies on the wire."""
    kind = wire_kind(bits)
    if kind == "float32":
        return 4 * padded_size
    nscales = n_scale_blocks(block, padded_size)
    if kind == "int4":
        return (padded_size + 1) // 2 + 4 * nscales
    per = {"int8": 1, "int16": 2, "int32": 4}[kind]
    return per * padded_size + 4 * nscales


@dataclasses.dataclass(frozen=True)
class PackedRow:
    """One client's uplink in wire form: quantized symbols + f32 scales.

    data: (M//2,) uint8 int4 nibbles (low nibble at the even index),
    (M,) int8/int16/int32 symbols, or the (M,) f32 row for an
    unquantized client. scale: the () per-row scale, or an (n_blocks,)
    vector where symbol p belongs to block p // qblock; 1 for f32 rows.
    """

    data: torch.Tensor
    scale: torch.Tensor
    bits: int
    qblock: int = 0

    @property
    def kind(self) -> str:
        return wire_kind(self.bits)

    @property
    def n_scales(self) -> int:
        return max(int(self.scale.numel()), 1)

    @property
    def wire_nbytes(self) -> int:
        n = int(self.data.numel()) * self.data.element_size()
        return n if self.kind == "float32" else n + 4 * self.n_scales


def is_packed_rows(x: Any) -> bool:
    return (
        isinstance(x, (list, tuple))
        and len(x) > 0
        and all(isinstance(r, PackedRow) for r in x)
    )


def make_layout(tree: Tree, block: int = DEFAULT_BLOCK) -> Layout:
    """Derive the flat layout of ``tree`` (leaf order = sorted dict keys)."""
    leaves, treedef = tree_flatten(tree)
    shapes, dtypes, sizes, offsets = [], [], [], []
    off = 0
    for leaf in leaves:
        shapes.append(tuple(int(d) for d in leaf.shape))
        dtypes.append(str(leaf.dtype).replace("torch.", ""))
        n = int(leaf.numel())
        sizes.append(n)
        offsets.append(off)
        off += n
    padded = -(-max(off, 1) // block) * block
    return Layout(
        treedef=treedef,
        shapes=tuple(shapes),
        dtypes=tuple(dtypes),
        sizes=tuple(sizes),
        offsets=tuple(offsets),
        size=off,
        padded_size=padded,
        block=block,
    )


def pack(tree: Tree, layout: Layout) -> torch.Tensor:
    """Ravel + concat + zero-pad ``tree`` into a ``(padded_size,)`` f32 vector."""
    leaves, _ = tree_flatten(tree)
    assert len(leaves) == layout.n_leaves, (len(leaves), layout.n_leaves)
    flat = [leaf.to(torch.float32).reshape(-1) for leaf in leaves]
    if layout.padding:
        flat.append(flat[0].new_zeros((layout.padding,)))
    return torch.cat(flat)


def pack_batch(trees, layout: Layout) -> torch.Tensor:
    """Stack K packed client updates into the ``(K, padded_size)`` matrix."""
    return torch.stack([pack(t, layout) for t in trees])


def unpack(flat: torch.Tensor, layout: Layout, *, cast: bool = True) -> Tree:
    """Inverse of ``pack``; ``cast=False`` keeps every leaf f32."""
    leaves = []
    for shape, dtype, off, size in zip(
        layout.shapes, layout.dtypes, layout.offsets, layout.sizes
    ):
        leaf = flat[off : off + size].reshape(shape)
        leaves.append(leaf.to(_DTYPES[dtype]) if cast else leaf)
    return tree_unflatten(layout.treedef, leaves)
