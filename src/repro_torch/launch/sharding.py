"""Parameter / input / cache partition specs for the production mesh (the
JAX package's ``launch/sharding.py``), and the placement that cuts a tree
into its pieces by them.

Megatron-style tensor parallelism over ``model`` (attention heads, FFN
width, MoE experts, SSM channels) composed with FSDP over ``data`` (and
``pod``) on the complementary dimension. Rules are name-based over the
tree path and guarded by divisibility: a dim that doesn't divide the axis
size stays unsharded. The rules are the reference's, line for line; a
spec is the port's own ``P``, a tuple of one entry a dim (None, an axis
name, or a tuple of names).

Where the reference hands ``to_named(specs, mesh)`` to ``jax.device_put``,
the port's ``place(tree, to_named(specs, mesh))`` cuts each leaf into its
pieces and copies each piece to its mesh device (``Placed``); ``gather``
puts the pieces back together on one device, bit for bit. A piece's shape
is the leaf's with each sharded dim divided by its axes' size, so
``device_nbytes`` reckons each device's bytes from the specs alone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh

Pytree = Any

# leaf names whose *last* dim is the parallel (output) dim
COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "x_proj",
                "dt_proj", "router", "frame_proj", "vis_proj", "w_x", "w_h",
                "conv1_w", "conv2_w", "out_w"}
# leaf names whose *first non-stack* dim is the parallel (input) dim
ROW_PARALLEL = {"wo", "w_down", "out_proj"}


class P(tuple):
    """A partition spec: one entry a dim, None (replicated), an axis name,
    or a tuple of axis names (sharded over their product, major first). A
    tuple of one name is that name, as in the reference's PartitionSpec."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axis_size(mesh: Mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(name, 1)


def _fits(dim: int, mesh: Mesh, axis) -> bool:
    return axis is not None and dim % _axis_size(mesh, axis) == 0


def _dp_axis(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def is_expert_weight(path: Tuple[str, ...], shape: Tuple[int, ...]) -> bool:
    """``param_spec``'s rule for MoE expert-stacked weights, (L, E, a, b) or
    (E, a, b): a ``w_gate``, ``w_up`` or ``w_down`` of 3 dims or more with
    "moe" in its path."""
    return path[-1] in ("w_gate", "w_up", "w_down") and len(shape) >= 3 and "moe" in path


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh: Mesh,
               n_kv_heads: int = 0) -> P:
    """PartitionSpec for one parameter leaf addressed by its dict path."""
    name = path[-1]
    dp = _dp_axis(mesh)
    mp = "model"
    nd = len(shape)

    # GQA: wk/wv output dims are (kv_heads * head_dim). If the kv-head
    # count doesn't divide the TP axis, sharding the flat dim would split
    # head_dim; replicate instead: these projections are tiny.
    if name in ("wk", "wv", "bk", "bv") and n_kv_heads:
        if n_kv_heads % _axis_size(mesh, mp) != 0:
            lead = [None] * (nd - 2)
            if nd >= 2:
                return P(*lead, dp if _fits(shape[-2], mesh, dp) else None,
                         None)
            return P(*([None] * nd))

    def guarded(*entries):
        out = []
        for dim, ax in zip(shape, entries):
            out.append(ax if _fits(dim, mesh, ax) else None)
        return P(*out)

    if name == "embed":
        return guarded(mp, dp)
    if name == "lm_head":
        # vocab-parallel only: sharding the contraction (d) dim over data
        # would all-reduce every (B, S, V) logits tensor across the data axis
        return guarded(None, mp)
    # MoE expert-stacked weights: (L, E, a, b) or (E, a, b)
    if is_expert_weight(path, shape):
        lead = [None] * (nd - 3)
        e, a, b = shape[-3:]
        e_ax = mp if _fits(e, mesh, mp) else None
        if name == "w_down":
            return P(*lead, e_ax, None, dp if _fits(b, mesh, dp) else None)
        return P(*lead, e_ax, dp if _fits(a, mesh, dp) else None, None)
    if name in COL_PARALLEL and nd >= 2:
        lead = [None] * (nd - 2)
        a, b = shape[-2:]
        return P(*lead,
                 dp if _fits(a, mesh, dp) else None,
                 mp if _fits(b, mesh, mp) else None)
    if name in ROW_PARALLEL and nd >= 2:
        lead = [None] * (nd - 2)
        a, b = shape[-2:]
        return P(*lead,
                 mp if _fits(a, mesh, mp) else None,
                 dp if _fits(b, mesh, dp) else None)
    if name == "conv_w":  # (L, K, C): shard channels
        return P(*([None] * (nd - 1)),
                 mp if _fits(shape[-1], mesh, mp) else None)
    if name in ("A_log", "D", "dt_bias", "conv_b") and nd >= 1:
        # per-channel SSM params: shard the channel dim (first after stack)
        entries = [None] * nd
        ch_idx = 1 if nd >= 2 else 0
        if _fits(shape[ch_idx], mesh, mp):
            entries[ch_idx] = mp
        return P(*entries)
    # norms, biases, scalars: replicated
    return P(*([None] * nd))


def tree_param_specs(shapes: Pytree, mesh: Mesh, n_kv_heads: int = 0) -> Pytree:
    """Map a tree of tensors (meta tensors will do) to a tree of specs."""

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = type(node)
            return t(walk(path + (str(i),), v) for i, v in enumerate(node))
        return param_spec(path, tuple(node.shape), mesh, n_kv_heads=n_kv_heads)

    return walk((), shapes)


def batch_spec(shapes: Dict[str, Any], mesh: Mesh) -> Dict[str, P]:
    """Inputs: shard the batch (first) dim over (pod, data) when divisible."""
    dp = _dp_axis(mesh)
    out = {}
    for k, v in shapes.items():
        if v.dim() >= 1 and _fits(v.shape[0], mesh, dp):
            out[k] = P(dp, *([None] * (v.dim() - 1)))
        else:
            out[k] = P(*([None] * v.dim()))
    return out


def cache_spec(shapes: Pytree, mesh: Mesh) -> Pytree:
    """Decode caches: (L, B, ...) -- batch over data when divisible; for
    attention caches also try kv-heads over model; SSM channel dims over
    model."""
    dp = _dp_axis(mesh)
    mp = "model"

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        name = path[-1]
        s = node.shape
        entries = [None] * len(s)
        # find batch dim: caches are stacked (L, B, ...) or (L, seg, B, ...)
        for i, d in enumerate(s[:3]):
            if _fits(d, mesh, dp) and i >= 1:
                entries[i] = dp
                break
        if name in ("k", "v") and len(s) >= 2:
            if _fits(s[-2], mesh, mp):
                entries[-2] = mp
        if name in ("h", "ssm_h", "conv", "ssm_conv") and len(s) >= 2:
            # channel-ish dim: h (L,B,di,N) -> di; conv (L,B,K-1,di) -> di
            idx = -2 if name in ("h", "ssm_h") else -1
            if _fits(s[idx], mesh, mp):
                entries[idx] = mp
        return P(*entries)

    return walk((), shapes)


# ------------------------------------------------------------- placement


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: P

    def bounds(self, shape, idx) -> Tuple[Tuple[int, int], ...]:
        """[start, stop) of each dim of a ``shape`` leaf's piece on mesh
        index ``idx``."""
        return _piece_bounds(shape, self, idx)


def _map_specs(fn: Callable, tree: Pytree) -> Pytree:
    """``fn`` on every leaf of a tree whose leaves are specs (a ``P`` is a
    tuple, so a plain tree map would walk into it)."""
    if isinstance(tree, (P, NamedSharding)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return fn(tree)


def to_named(spec_tree: Pytree, mesh: Mesh) -> Pytree:
    return _map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


def _entries(spec: P, ndim: int) -> Tuple:
    """The spec's entries padded with None to ``ndim``, each a tuple of
    axis names (empty: replicated)."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(spec)):
        out.append(() if e is None else (e,) if isinstance(e, str) else tuple(e))
    return tuple(out)


def model_dim(spec: P, ndim: int):
    """The dim of a leaf of ``ndim`` dims that ``spec`` splits over
    ``model`` (alone or with other axes), or None."""
    for i, axes in enumerate(_entries(spec, ndim)):
        if "model" in axes:
            return i
    return None


def _piece_bounds(shape, sharding: NamedSharding, idx) -> Tuple[Tuple[int, int], ...]:
    """[start, stop) of each dim of the piece on mesh index ``idx``."""
    mesh = sharding.mesh
    pos = dict(zip(mesh.axis_names, idx))
    out = []
    for dim, axes in zip(shape, _entries(sharding.spec, len(shape))):
        n, k = 1, 0
        for a in axes:  # major axis first
            size = _axis_size(mesh, a)
            k = k * size + pos.get(a, 0)
            n *= size
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {axes} ({n} shards)")
        step = dim // n
        out.append((k * step, (k + 1) * step))
    return tuple(out)


def piece_shape(shape, spec: P, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of each piece of a leaf of ``shape`` placed by ``spec``."""
    return tuple(dim // _axis_size(mesh, axes)
                 for dim, axes in zip(shape, _entries(spec, len(shape))))


def spec_nbytes(shape, itemsize: int, spec: P, mesh: Mesh) -> int:
    """Bytes of the piece each device holds of a leaf placed by ``spec``."""
    return math.prod(piece_shape(shape, spec, mesh)) * itemsize


@dataclasses.dataclass(frozen=True, eq=False)
class Placed:
    """A leaf cut into its pieces: ``pieces[idx]`` is the piece of mesh
    index ``idx``, a tensor of its own on ``mesh.devices[idx]`` (a dim
    replicated over an axis is copied to every device along it)."""

    pieces: np.ndarray
    sharding: NamedSharding
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def bounds(self, idx) -> Tuple[Tuple[int, int], ...]:
        return _piece_bounds(self.shape, self.sharding, idx)

    def block(self, rows: Tuple[int, int], device) -> torch.Tensor:
        """Rows ``[start, stop)`` of dim 0, every other dim whole, on
        ``device``: a piece that sits there and covers exactly that block
        as it is, else assembled from the pieces (those on ``device``
        first), which is the reference's all-gather over the other axes."""
        return self.box((rows,) + tuple((0, d) for d in self.shape[1:]), device)

    def box(self, want, device) -> torch.Tensor:
        """The box ``want`` (``[start, stop)`` a dim) on ``device``, as
        ``block`` reads its rows."""
        device = torch.device(device)
        want = tuple(tuple(w) for w in want)
        for idx in np.ndindex(self.pieces.shape):
            if self.pieces[idx].device == device and self.bounds(idx) == want:
                return self.pieces[idx]
        return _assemble(self, want, device)

    def piece(self, i: int, m: int) -> Tuple[Tuple[Tuple[int, int], ...], torch.Tensor]:
        """(bounds, piece) of data shard ``i`` and model shard ``m``
        (``grid_index``): the tensor itself, not a copy."""
        idx = grid_index(self.sharding.mesh, i, m)
        return self.bounds(idx), self.pieces[idx]


def grid_index(mesh: Mesh, i: int, m: int) -> Tuple[int, ...]:
    """The mesh index of data shard ``i`` (over ("pod", "data"), major
    first) and model shard ``m``; any other axis at 0."""
    names = tuple(mesh.axis_names)
    dp_axes = [a for a in ("pod", "data") if a in names]
    coords = dict(zip(dp_axes, np.unravel_index(i, [_axis_size(mesh, a) for a in dp_axes])))
    if m and "model" not in names:
        raise ValueError(f"model shard {m} of a mesh without a model axis")
    coords["model"] = m
    return tuple(int(coords.get(a, 0)) for a in names)


def from_pieces(pieces: np.ndarray, sharding: NamedSharding, shape) -> Placed:
    """A ``Placed`` of tensors already computed on their devices: ``pieces``
    holds one a mesh index, each of its bounds' shape on that index's
    device, none a view of another (each is updated in place on its own)."""
    mesh = sharding.mesh
    shape = tuple(shape)
    if pieces.shape != mesh.devices.shape:
        raise ValueError(f"{pieces.shape} pieces for a mesh of {mesh.devices.shape}")
    dtype = pieces.flat[0].dtype
    for idx in np.ndindex(pieces.shape):
        t, want = pieces[idx], _piece_bounds(shape, sharding, idx)
        if (tuple(t.shape) != tuple(e - s for s, e in want) or t.dtype != dtype
                or t.device != torch.device(mesh.devices[idx])):
            raise ValueError(f"piece {idx} is {tuple(t.shape)} {t.dtype} on {t.device}, want "
                             f"the box {want} of {dtype} on {mesh.devices[idx]}")
    return Placed(pieces, sharding, shape, dtype)


def _contains(box, want) -> bool:
    return all(s <= w0 and w1 <= e for (s, e), (w0, w1) in zip(box, want))


def _cut(t: torch.Tensor, box, want) -> torch.Tensor:
    """The view of ``t`` (which holds ``box``) on ``want``."""
    return t[tuple(slice(w0 - s, w1 - s) for (s, _), (w0, w1) in zip(box, want))]


def assemble(sources, want, device, dtype) -> torch.Tensor:
    """A new tensor on ``device`` holding the box ``want``, copied from
    ``sources``, (box, tensor) pairs that together cover it (those on
    ``device`` first; a box that repeats is read once)."""
    device = torch.device(device)
    out = torch.empty(tuple(b - a for a, b in want), dtype=dtype, device=device)
    done = set()
    for b, t in sorted(sources, key=lambda s: s[1].device != device):
        if b in done:
            continue
        lo = [max(s, w0) for (s, _), (w0, _) in zip(b, want)]
        hi = [min(e, w1) for (_, e), (_, w1) in zip(b, want)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        done.add(b)
        src = t[tuple(slice(l - s, h - s) for l, h, (s, _) in zip(lo, hi, b))]
        out[tuple(slice(l - w0, h - w0) for l, h, (w0, _) in zip(lo, hi, want))].copy_(src)
    return out


def read_box(sources, want, device) -> torch.Tensor:
    """The box ``want`` on ``device`` out of (box, tensor) ``sources``: a
    view of a source on ``device`` that holds it, else a copy of the view
    of one that holds it elsewhere, else assembled from several."""
    device = torch.device(device)
    want = tuple(tuple(w) for w in want)
    holders = [(b, t) for b, t in sources if _contains(b, want)]
    for b, t in holders:
        if t.device == device:
            return _cut(t, b, want)
    if holders:
        b, t = holders[0]
        return _cut(t, b, want).to(device)
    return assemble(sources, want, device, sources[0][1].dtype)


def _assemble(placed: Placed, want, device) -> torch.Tensor:
    sources = [(placed.bounds(idx), placed.pieces[idx])
               for idx in np.ndindex(placed.pieces.shape)]
    return assemble(sources, want, device, placed.dtype)


def _place_leaf(t: torch.Tensor, sharding: NamedSharding) -> Placed:
    mesh = sharding.mesh
    shape = tuple(t.shape)
    pieces = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(mesh.devices.shape):
        b = _piece_bounds(shape, sharding, idx)
        piece = torch.empty(tuple(e - s for s, e in b), dtype=t.dtype, device=mesh.devices[idx])
        piece.copy_(t[tuple(slice(s, e) for s, e in b)])
        pieces[idx] = piece
    return Placed(pieces, sharding, shape, t.dtype)


def place(tree: Pytree, shardings: Pytree) -> Pytree:
    """Cut each leaf of ``tree`` into its pieces by the matching
    ``NamedSharding`` of ``shardings`` (``to_named(specs, mesh)``) and copy
    each piece to its mesh device: a tree of ``Placed``."""
    if isinstance(shardings, NamedSharding):
        return _place_leaf(tree, shardings)
    if isinstance(tree, dict):
        return {k: place(tree[k], shardings[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(a, b) for a, b in zip(tree, shardings))
    raise TypeError(f"no sharding for a leaf of type {type(tree).__name__}")


def gather(tree: Pytree, device=None) -> Pytree:
    """The inverse of ``place``: each ``Placed`` leaf put back together on
    ``device`` (default: the mesh's first device), bit for bit."""
    if isinstance(tree, Placed):
        dev = tree.sharding.mesh.devices.flat[0] if device is None else torch.device(device)
        return _assemble(tree, tuple((0, d) for d in tree.shape), dev)
    if isinstance(tree, dict):
        return {k: gather(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather(v, device) for v in tree)
    return tree


def device_nbytes(tree: Pytree) -> np.ndarray:
    """Bytes each mesh device holds of a tree of ``Placed``, in the mesh's
    shape (what ``place`` allocated)."""
    total = None
    for leaf in _placed_leaves(tree):
        sizes = np.vectorize(lambda p: p.numel() * p.element_size(), otypes=[np.int64])(
            leaf.pieces)
        total = sizes if total is None else total + sizes
    return total


def _placed_leaves(tree: Pytree):
    if isinstance(tree, Placed):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _placed_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _placed_leaves(v)


def tree_spec_nbytes(shapes: Pytree, specs: Pytree, mesh: Mesh) -> int:
    """Bytes each device holds of a tree of tensors (meta tensors will do)
    placed by a matching tree of specs, reckoned from the specs alone."""
    if isinstance(specs, P):
        return spec_nbytes(tuple(shapes.shape), shapes.element_size(), specs, mesh)
    if isinstance(shapes, dict):
        return sum(tree_spec_nbytes(shapes[k], specs[k], mesh) for k in shapes)
    if isinstance(shapes, (list, tuple)):
        return sum(tree_spec_nbytes(a, b, mesh) for a, b in zip(shapes, specs))
    raise TypeError(f"no spec for a leaf of type {type(shapes).__name__}")
