"""Step functions (the JAX package's ``launch/steps.py``): the train
state, the training step and the client's quantized local training step,
with PyTorch autograd, and the serving path's prefill and decode steps.

A train state is ``{"params", "opt", "step"}``, ``step`` a 0-d int32
tensor on the params' device, as the reference's, so a checkpoint of it
loads in either package.

``make_sharded_train_step`` is the port's counterpart of the reference's
``jax.jit(make_train_step(model, opt), in_shardings=...)``: the same step
on a train state placed on a ``launch.mesh.Mesh`` (``launch.sharding``),
with data-parallel gradients, each piece's update on its device and,
with ``tensor_parallel``, the attention, MLP, Mamba, embedding and head
split over the mesh's ``model`` axis. ``make_sharded_prefill_step`` and
``make_sharded_decode_step`` are the jitted prefill and (donating) decode
under the same specs: the same routes without a gradient, the cache a
tree of pieces cut by ``cache_spec`` and updated in place.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import quant
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ssm as S
from repro_torch.models.registry import CACHE_LAYOUT, Model
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.optim.optimizers import clip_leaves, clip_scale
from repro_torch.util import use_mesh


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


def make_train_step(model: Model, opt: Optimizer, *, clip_norm: float = 1.0,
                    donate: bool = False) -> Callable:
    """One step: loss and gradients, global-norm clip, the optimizer, the
    update added in f32 and cast back to each param's dtype.

    With ``donate`` the step consumes its input state, as the reference's
    ``jax.jit(..., donate_argnums=(0,))``: where jax would delete the
    donated buffers, the step writes the new params, moments and ``step``
    into the given tensors (each keeps its storage) and returns the given
    state, so the caller's old values are gone. The gradients are clipped
    leaf by leaf and each leaf is updated in boxes of its rows
    (``_update_leaf``), so the step's peak is the state, the gradients
    and one box's temporaries; the results are the step's without
    ``donate`` bit for bit. Tensors of the state that share storage raise
    ``ValueError`` before anything is written."""

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        if donate:
            _check_donation(tree_leaves({k: state[k] for k in ("params", "opt", "step")}))
        loss, metrics, grads, params = _value_and_grad(model, state["params"], batch)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if donate:
            g_leaves = tree_leaves(grads)
            del grads, params
            gnorm = clip_leaves(g_leaves, clip_norm)
            _donated_update(opt, state, g_leaves)
            return state, dict(metrics, loss=loss, grad_norm=gnorm)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = opt.update(grads, state["opt"], params, state["step"])
        del grads
        new_state = {"params": _apply(params, updates), "opt": opt_state,
                     "step": state["step"] + 1}
        return new_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


# ------------------------------------------------------- the donating update

# the donating update takes a leaf in boxes of dim 0's rows of at most this
# many values (a stacked leaf one layer or a few at a time), so at most one
# box's f32 temporaries are alive
DONATE_BOX_VALUES = 1 << 24


def _check_donation(tensors) -> None:
    """Raise ``ValueError`` where two donated tensors share storage (the
    same tensor for two leaves, or views of one buffer): written in place,
    one would overwrite the other, and jax refuses to donate one buffer
    twice."""
    seen = set()
    for t in tensors:
        store = t.untyped_storage()
        if store.nbytes() == 0:
            continue
        key = (t.device, store.data_ptr())
        if key in seen:
            raise ValueError(f"two tensors of the donated state share storage ({t.device}, "
                             f"{tuple(t.shape)} {t.dtype}): each leaf must own its buffer")
        seen.add(key)


def _row_boxes(shape, blockwise: bool) -> List[Tuple[Tuple[int, int], ...]]:
    """The boxes the donating update takes a leaf of ``shape`` in, in turn:
    ranges of dim 0's rows of at most ``DONATE_BOX_VALUES`` values, or one
    row where a row holds more (a stacked leaf's layer). With
    ``blockwise`` state each box but the last holds whole
    ``quant.STATE_BLOCK`` blocks of the flattened leaf, so requantizing a
    box gives the leaf's own blocks."""
    full = _full(shape)
    if not shape:
        return [full]
    row = math.prod(shape[1:])
    n = max(1, DONATE_BOX_VALUES // max(row, 1))
    if blockwise:
        q = quant.STATE_BLOCK // math.gcd(row, quant.STATE_BLOCK)
        n = max(q, n - n % q)
    if n >= shape[0]:
        return [full]
    return [((r, min(r + n, shape[0])),) + full[1:] for r in range(0, shape[0], n)]


def _state_box(name: str, box, shape) -> Tuple[Tuple[int, int], ...]:
    """A moment's box for the param box ``box`` of a leaf of ``shape``: the
    same box, but ``v_scale``'s (one scale a block of the flattened leaf)
    is the blocks the box's values fill."""
    if name != "v_scale":
        return box
    row = math.prod(shape[1:])
    lo, hi = (box[0][0] * row, box[0][1] * row) if box else (0, 1)
    return ((lo // quant.STATE_BLOCK, -(-hi // quant.STATE_BLOCK)),)


class _Boxes:
    """A leaf as (box, tensor) sources (a donated tensor, a ``Placed``
    leaf's pieces, a gradient's distinct pieces), read by box on
    ``device`` (``sharding.read_box``: a view where a source there holds
    the box, else a copy) and written back into every source that holds
    part of the box (gradients are only read)."""

    def __init__(self, sources, device):
        self.sources, self.device = sources, device

    @classmethod
    def whole(cls, t: torch.Tensor) -> "_Boxes":
        return cls([(_full(t.shape), t)], t.device)

    @classmethod
    def placed(cls, leaf: shd.Placed, device) -> "_Boxes":
        return cls([(leaf.bounds(idx), leaf.pieces[idx])
                    for idx in np.ndindex(leaf.pieces.shape)], device)

    def read(self, box) -> torch.Tensor:
        return shd.read_box(self.sources, box, self.device)

    def write(self, box, src: torch.Tensor) -> None:
        for b, t in self.sources:
            _copy_box(t, b, src, box)


def _update_leaf(opt: Optimizer, step: torch.Tensor, grad, param, moments, shape) -> None:
    """The donating update of one leaf of ``shape``, its gradient, param
    and moments each read (and the param and moments written) through
    ``_Boxes``, box by box (``_row_boxes``): the step's scalars from
    ``step`` (``opt.prepare``),
    each box's update and new moments by ``opt.leaf`` from its old values,
    the param's ``(p + u)`` in f32 cast back as ``_apply``, all computed
    before the box's first write, so a read that returned the storage
    itself is not overwritten under it. Run under ``torch.no_grad()``."""
    sc = opt.prepare(step)
    blockwise = any(n in _BLOCKWISE_STATE for n in opt.names)
    for box in _row_boxes(shape, blockwise):
        m_boxes = [_state_box(n, box, shape) for n in opt.names]
        p = param.read(box)
        u, new = opt.leaf(sc, grad.read(box), p,
                          tuple(m.read(b) for m, b in zip(moments, m_boxes)))
        new_p = (p.to(torch.float32) + u).to(p.dtype)
        del u, p
        for m, b, t in zip(moments, m_boxes, new):
            m.write(b, t)
        param.write(box, new_p)
        del new, new_p


def _advance(step: torch.Tensor) -> None:
    """``step`` + 1 in place, once every leaf is updated: the schedule
    reads it in each leaf's ``opt.prepare``."""
    step.add_(1)


def _donated_update(opt: Optimizer, state: Dict[str, Any], g_leaves: List) -> None:
    """The unsharded step's update written into ``state``: leaf by leaf,
    each gradient freed once its leaf is updated, then the step."""
    p_leaves = tree_leaves(state["params"])
    moments = [tree_leaves(state["opt"][n]) for n in opt.names]
    with torch.no_grad():
        for k, p in enumerate(p_leaves):
            _update_leaf(opt, state["step"], _Boxes.whole(g_leaves[k]), _Boxes.whole(p),
                         [_Boxes.whole(m[k]) for m in moments], tuple(p.shape))
            g_leaves[k] = None
        _advance(state["step"])


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


# ------------------------------------------------------- the sharded train step

# optimizer state quantized in blocks of the flattened leaf: a piece that
# cuts across blocks cannot be requantized alone
_BLOCKWISE_STATE = ("v_q", "v_scale")


def _shard_grid(mesh: Mesh) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """The mesh's devices as a (dp, mp) array, as the MoE branch reads
    them (``models/layers._shard_devices``): row i data shard i over
    ("pod", "data"), major first, column m model shard m, any other axis
    at index 0; and the data axes."""
    names = list(mesh.axis_names)
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    order = [names.index(a) for a in dp_axes + (("model",) if "model" in names else ())]
    rest = [i for i in range(len(names)) if i not in order]
    devs = np.transpose(mesh.devices, order + rest)[(Ellipsis,) + (0,) * len(rest)]
    return devs.reshape(math.prod(mesh.shape[a] for a in dp_axes), -1), dp_axes


def _row_mesh(mesh: Mesh, dp_axes: Tuple[str, ...], i: int) -> Mesh:
    """Data shard i's own mesh: its devices, the data axes of size 1."""
    coords = dict(zip(dp_axes, np.unravel_index(i, [mesh.shape[a] for a in dp_axes])))
    index = tuple(slice(coords[a], coords[a] + 1) if a in coords else slice(None)
                  for a in mesh.axis_names)
    return Mesh(mesh.devices[index], tuple(mesh.axis_names))


def _full(shape) -> Tuple[Tuple[int, int], ...]:
    return tuple((0, d) for d in shape)


def _leaf_paths(tree, path=()) -> List[Tuple[str, ...]]:
    """Each leaf's dict path, in ``tree_flatten``'s order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _leaf_paths(v, path + (str(i),))]
    return [path]


def _is_expert_stack(path, shape, mp: int) -> bool:
    """An MoE expert stack whose experts divide over ``mp`` model shards:
    a leaf of the spec rule's (``sharding.is_expert_weight``) that sits
    right under "moe". The rule also takes arctic's dense residual
    (``moe.dense_mlp``), which the MoE reads as a plain MLP."""
    return (mp > 1 and shd.is_expert_weight(path, shape) and path[-2] == "moe"
            and shape[-3] % mp == 0)


def _read(leaf, want, device) -> torch.Tensor:
    """The box ``want`` of a ``Placed`` leaf or a tensor, on ``device``."""
    if isinstance(leaf, shd.Placed):
        return leaf.box(want, device)
    return shd.read_box([(_full(leaf.shape), leaf)], want, device)


# the attention blocks' parents: the decoder LMs' and the hybrid's shared
# block's ``attn``, whisper's encoder ``attn``, ``self_attn`` and ``cross_attn``
_ATTENTIONS = ("attn", "self_attn", "cross_attn")
# the leaves the tensor-parallel step reads split over the model axis, by
# (parent, name): the dim each splits, counted from the end (the
# column-parallel outputs, the row-parallel inputs, the vocab)
_TP_LEAVES = {**{(a, n): ax for a in _ATTENTIONS
                 for n, ax in (("wq", -1), ("wk", -1), ("wv", -1), ("wo", -2))},
              ("mlp", "w_gate"): -1, ("mlp", "w_up"): -1, ("mlp", "w_down"): -2,
              ("dense_mlp", "w_gate"): -1, ("dense_mlp", "w_up"): -1,
              ("dense_mlp", "w_down"): -2, (None, "embed"): -2, (None, "lm_head"): -1}
# the families whose blocks (``models/layers``' attention, MLP and MoE,
# ``models/ssm``'s Mamba blocks) and vocab (``models/transformer``'s
# embedding and head) have tensor-parallel branches
_TP_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")
# the stacked layer axes in front of each leaf under a top-level key
_STACKED = {"layers": 1, "enc_layers": 1, "dec_layers": 1, "segments": 2}


def _tp_axis(path, shape, spec, cfg, mp: int) -> Optional[int]:
    """The dim (from the end) of a leaf that the tensor-parallel step
    reads as model-shard blocks, or None (whole). A Mamba block's leaf
    (parent "mamba") splits by its channels or heads wherever the block
    divides ``mp`` (``models/ssm.split_axis``), each block read from the
    pieces that hold it whatever the spec. Any other: a ``_TP_LEAVES``
    leaf whose spec splits that dim over ``model``; an attention's only
    where its heads (and, for ``wk``/``wv``, its kv heads) divide ``mp``,
    so a head is never split; the embedding only where the head does not
    tie it."""
    if cfg is None or mp == 1 or cfg.family not in _TP_FAMILIES:
        return None
    parent, name = (path[-2] if len(path) > 1 else None), path[-1]
    if parent == "mamba":
        return S.split_axis(cfg, name, mp)
    axis = _TP_LEAVES.get((parent, name))
    if axis is None or shd.model_dim(spec, len(shape)) != len(shape) + axis:
        return None
    if parent in _ATTENTIONS and (cfg.n_heads % mp
                                  or (name in ("wk", "wv") and cfg.n_kv_heads % mp)):
        return None
    if name == "embed" and cfg.tie_embeddings:
        return None
    return axis


class _Blocks:
    """One data shard's leaf split over the model axis: ``blocks[m]`` is
    model shard m's block, the m-th slice of dim ``axis`` (counted from
    the end), on the shard's m-th device, a leaf that requires grad.
    ``lead`` stacked layer axes come first (the hybrid's two: segment and
    layer); ``unbind`` takes them off one at a time (the models' layer
    loops).

    The tensor-parallel branches (``models/layers``' attention and MLP,
    ``models/ssm``'s Mamba blocks, ``models/whisper``'s cross-attention,
    ``models/transformer``'s embedding and head) read ``blocks``. The MoE
    reads an expert stack (``axis`` -3) through ``block``
    (``models/layers._expert_block``): model shard m's rows are
    ``blocks[m]`` itself where they are asked for on its device, so its
    gradient is that block's share. Rows asked for elsewhere or across
    blocks (the local path reads every expert on the shard's device) come
    as a copy, through which autograd carries the gradient back."""

    def __init__(self, blocks: List[torch.Tensor], axis: int, lead: int):
        self.blocks, self.axis, self.lead = blocks, axis, lead

    def unbind(self, dim: int = 0) -> List["_Blocks"]:
        if dim != 0 or not self.lead:
            raise ValueError("only the leading layer axes of a block leaf unbind")
        return [_Blocks(list(layer), self.axis, self.lead - 1)
                for layer in zip(*(b.unbind(0) for b in self.blocks))]

    def block(self, rows: Tuple[int, int], device) -> torch.Tensor:
        if self.lead:
            raise ValueError("unbind the layer axes of a block leaf first")
        n = self.blocks[0].shape[self.axis]
        device = torch.device(device)
        parts = []
        for m, b in enumerate(self.blocks):
            lo, hi = max(rows[0] - m * n, 0), min(rows[1] - m * n, n)
            if lo < hi:
                parts.append(b.narrow(self.axis, lo, hi - lo).to(device))
        return parts[0] if len(parts) == 1 else torch.cat(parts, self.axis)


def _shard_live(params, mesh: Mesh, cfg=None, grad: bool = True):
    """Data shard 0 of ``mesh``'s live params: each leaf (``Placed`` or a
    tensor) read whole onto the shard's first device, a leaf that
    requires grad (no copy where a whole piece already sits there); an
    MoE expert stack, and with ``cfg`` (the tensor-parallel step) each
    leaf ``_tp_axis`` names, as ``_Blocks``: block m, that dim's m-th
    slice on the row's m-th device, read from the pieces that hold it
    (gathered over the data axes only where the spec splits that dim over
    ``model``; a Mamba leaf's slice may cross pieces, such as
    ``x_proj``'s rows of its column pieces).
    A leaf's spec is its placement's (a tensor's: ``param_spec``). With
    ``grad`` False (the sharded prefill and decode) no leaf requires grad.
    Returns (the tree, [(leaf index, box, live tensor)])."""

    def live(t: torch.Tensor) -> torch.Tensor:
        return t.detach().requires_grad_(True) if grad else t.detach()

    grid, _ = _shard_grid(mesh)
    row = list(grid[0])
    mp = len(row)
    leaves, structure = tree_flatten(params)
    out, lives = [], []
    for k, (path, leaf) in enumerate(zip(_leaf_paths(params), leaves)):
        shape = tuple(leaf.shape)
        full = _full(shape)
        if _is_expert_stack(path, shape, mp):
            axis, lead = -3, len(shape) - 3
        else:
            spec = None
            if cfg is not None:
                spec = (leaf.sharding.spec if isinstance(leaf, shd.Placed) else
                        shd.param_spec(path, shape, mesh, n_kv_heads=cfg.n_kv_heads))
            axis, lead = _tp_axis(path, shape, spec, cfg, mp), _STACKED.get(path[0], 0)
        if axis is None:
            t = live(_read(leaf, full, row[0]))
            lives.append((k, full, t))
            out.append(t)
            continue
        ax, blocks = len(shape) + axis, []
        n = shape[ax] // mp
        for m, dev in enumerate(row):
            box = full[:ax] + ((m * n, (m + 1) * n),) + full[ax + 1:]
            blocks.append(live(_read(leaf, box, dev)))
            lives.append((k, box, blocks[-1]))
        out.append(_Blocks(blocks, axis, lead))
    return tree_unflatten(structure, out), lives


def _forward_backward(model: Model, live, lives, batch, mesh: Mesh, weight, dp: int):
    """``model.loss`` and its backward under ``use_mesh(mesh)``: remat
    recomputes the forward inside the backward and reads the ambient mesh
    again, so both run under the shard's own. With ``weight`` the
    objective is ``weight * ce + (loss - ce) / dp``: the batch's masked
    token mean and the mean over shards of the rest (the MoE's aux)."""
    with use_mesh(mesh):
        loss, metrics = model.loss(live, batch)
        if weight is not None:
            ce = metrics["ce"]
            loss = weight * ce + (loss - ce) / dp
        grads = torch.autograd.grad(loss, [t for _, _, t in lives], allow_unused=True)
    grads = [(k, box, torch.zeros_like(t) if g is None else g)
             for (k, box, t), g in zip(lives, grads)]
    return loss.detach(), {n: v.detach() for n, v in metrics.items()}, grads


def shard_value_and_grad(model: Model, params, batch: Dict[str, torch.Tensor], mesh: Mesh, *,
                         weight: Optional[torch.Tensor] = None, dp: int = 1,
                         tensor_parallel: bool = False):
    """One data shard's forward and backward, as the sharded step runs it:
    ``params`` (``Placed`` leaves or tensors) read onto data shard 0 of
    ``mesh`` (``_shard_live``; with ``tensor_parallel`` the model-split
    leaves as blocks over the shard's row), ``model.loss`` and its gradient
    under ``use_mesh(mesh)`` (``_forward_backward``). Returns (loss,
    metrics, [(leaf index, box, gradient)]); the live params are freed on
    return."""
    live, lives = _shard_live(params, mesh, model.cfg if tensor_parallel else None)
    return _forward_backward(model, live, lives, batch, mesh, weight, dp)


def _placed(tree, shardings):
    """Each leaf as a ``Placed`` by its ``NamedSharding``: a ``Placed``
    with that sharding as it is, a tensor (or a ``Placed`` with another
    sharding) placed first, as ``jit`` reshards its inputs."""
    if isinstance(shardings, shd.NamedSharding):
        if isinstance(tree, shd.Placed):
            if tree.sharding == shardings:
                return tree
            tree = shd.gather(tree)
        return shd.place(tree, shardings)
    if isinstance(tree, dict):
        return {k: _placed(tree[k], shardings[k]) for k in tree}
    return type(tree)(_placed(a, b) for a, b in zip(tree, shardings))


def _mesh_of(shardings) -> Mesh:
    meshes = {id(s.mesh): s.mesh for s in tree_leaves(shardings)}
    if len(meshes) != 1:
        raise ValueError(f"the shardings name {len(meshes)} meshes; the step takes one")
    return next(iter(meshes.values()))


def _check_step_meshes(*shardings) -> Mesh:
    """The one mesh that every tree of shardings names."""
    mesh = _mesh_of(shardings[0])
    if any(_mesh_of(s) is not mesh for s in shardings[1:]):
        raise ValueError("the step's inputs are placed on different meshes")
    return mesh


def _shard_batch(batch: Dict[str, shd.Placed], dp_axes, n: int, i: int, device):
    """Data shard i's rows of each input on ``device`` (the whole input
    where its batch dim is not sharded)."""
    out = {}
    for name, leaf in batch.items():
        full = _full(leaf.shape)
        lead = shd._entries(leaf.sharding.spec, len(leaf.shape))
        if any(lead[1:]) or (lead and lead[0] not in ((), dp_axes)):
            raise ValueError(f"input {name!r} is placed by {leaf.sharding.spec}: the step "
                             f"splits inputs over {dp_axes} on their batch dim only")
        if lead and lead[0]:
            rows = leaf.shape[0] // n
            full = ((i * rows, (i + 1) * rows),) + full[1:]
        out[name] = leaf.box(full, device)
    return out


def data_shards(model: Model, batch: Dict[str, Any], specs: Dict[str, shd.P], mesh: Mesh) -> int:
    """How many data shards the sharded step runs ``batch`` as (each input
    placed by its PartitionSpec in ``specs``): the mesh's data shards
    where an input's batch dim is split over the data axes and the loss
    splits over them under the whole mesh (``Model.shards_apart``: an
    MoE off its expert-parallel branch routes the whole batch together);
    else 1, the batch whole under the whole mesh, as the reference's
    ``jit`` runs it."""
    grid, dp_axes = _shard_grid(mesh)
    if not dp_axes or not any(shd._entries(s, len(batch[k].shape))[:1] == (dp_axes,)
                              for k, s in specs.items()):
        return 1
    with use_mesh(mesh):
        apart = model.shards_apart(batch)
    return grid.shape[0] if apart else 1


def _loss_weights(counts: List[torch.Tensor], dev0) -> List[torch.Tensor]:
    """Each shard's share of the batch's count (the weight of its ce)."""
    total = torch.clamp_min(sum(c.to(dev0) for c in counts), 1.0)
    return [c / total.to(c.device) for c in counts]


def _pieces(leaf: shd.Placed) -> Dict[Tuple, Tuple[int, ...]]:
    """{bounds: the first mesh index that holds them}: each distinct piece
    once, in the mesh's order."""
    out: Dict[Tuple, Tuple[int, ...]] = {}
    for idx in np.ndindex(leaf.pieces.shape):
        out.setdefault(leaf.bounds(idx), idx)
    return out


def _accumulate(acc: List[Dict], p_leaves, pieces, grads: list) -> None:
    """Add one data shard's gradients to the f32 sums, each distinct
    piece on its device (the reduce-scatter). ``grads`` is emptied and
    each leaf's gradients are freed once added, so the sums grow as the
    shard's gradients go."""
    sources: List[list] = [[] for _ in p_leaves]
    for k, box, g in grads:
        sources[k].append((box, g))
    grads.clear()
    for k, leaf in enumerate(p_leaves):
        for b, idx in pieces[k].items():
            part = shd.read_box(sources[k], b, leaf.pieces[idx].device)
            if b in acc[k]:
                acc[k][b].add_(part)
            else:
                acc[k][b] = part.to(dtype=torch.float32, copy=True)
            del part
        sources[k] = None


def _cast(acc: List[Dict], p_leaves) -> List[Dict]:
    """The f32 sums cast once to each param's dtype (the sums freed)."""
    return [{b: acc[k].pop(b).to(leaf.dtype) for b in list(acc[k])}
            for k, leaf in enumerate(p_leaves)]


def _clip(grads: List[Dict], clip_norm: float, dev0) -> torch.Tensor:
    """``clip_by_global_norm`` on the pieces: each leaf's square sum (its
    distinct pieces in the mesh's order) brought to ``dev0`` and summed
    in leaf order; every piece scaled by the one factor. Returns the
    norm."""
    norm = torch.sqrt(sum(sum(g.to(torch.float32).square().sum().to(dev0)
                              for g in leaf.values()) for leaf in grads))
    scale = clip_scale(norm, clip_norm)
    on: Dict[torch.device, torch.Tensor] = {}
    for leaf in grads:
        for b, g in leaf.items():
            s = on.setdefault(g.device, scale.to(g.device))
            leaf[b] = (g.to(torch.float32) * s).to(g.dtype)
    return norm


def _update(opt: Optimizer, p_leaves, p_struct, opt_state, step: shd.Placed,
            grads: List[Dict], dev0, donate: bool = False):
    """The optimizer and the update on the pieces. Element-wise state:
    ``opt.update`` on each mesh index's tree of pieces on its device.
    Blockwise state (``_BLOCKWISE_STATE``): each leaf whole on ``dev0``,
    cut again by its sharding. Returns (param leaves, opt state). With
    ``donate`` the pieces are written in place (``_donated_pieces``) and
    nothing is returned."""
    if donate:
        return _donated_pieces(opt, p_leaves, opt_state, step, grads, dev0)
    if any(name in _BLOCKWISE_STATE for name in opt_state):
        subs = {name: tree_flatten(sub) for name, sub in opt_state.items()}
        new_p, new_o = [], {name: [] for name in subs}
        s0 = step.box((), dev0)
        for k, leaf in enumerate(p_leaves):
            full = _full(leaf.shape)
            p = leaf.box(full, dev0)
            o = {name: leaves[k].box(_full(leaves[k].shape), dev0)
                 for name, (leaves, _) in subs.items()}
            u, o = opt.update(shd.read_box(list(grads[k].items()), full, dev0), o, p, s0)
            new_p.append(shd.place(_apply(p, u), leaf.sharding))
            for name, (leaves, _) in subs.items():
                new_o[name].append(shd.place(o[name], leaves[k].sharding))
            del p, u, o
        return new_p, {name: tree_unflatten(subs[name][1], new_o[name]) for name in subs}
    o_leaves, o_struct = tree_flatten(opt_state)
    shape = step.pieces.shape
    p_out = [np.empty(shape, dtype=object) for _ in p_leaves]
    o_out = [np.empty(shape, dtype=object) for _ in o_leaves]
    for idx in np.ndindex(shape):
        dev = step.pieces[idx].device
        g = tree_unflatten(p_struct, [grads[k][leaf.bounds(idx)].to(dev)
                                      for k, leaf in enumerate(p_leaves)])
        p = tree_unflatten(p_struct, [leaf.pieces[idx] for leaf in p_leaves])
        o = tree_unflatten(o_struct, [leaf.pieces[idx] for leaf in o_leaves])
        updates, o = opt.update(g, o, p, step.pieces[idx])
        for k, t in enumerate(tree_leaves(_apply(p, updates))):
            p_out[k][idx] = t
        for k, t in enumerate(tree_leaves(o)):
            o_out[k][idx] = t
        del g, updates, o
    new_o = [shd.Placed(a, leaf.sharding, leaf.shape, a.flat[0].dtype)
             for a, leaf in zip(o_out, o_leaves)]
    return ([shd.Placed(a, leaf.sharding, leaf.shape, leaf.dtype)
             for a, leaf in zip(p_out, p_leaves)], tree_unflatten(o_struct, new_o))


def _donated_pieces(opt: Optimizer, p_leaves, opt_state, step: shd.Placed, grads: List[Dict],
                    dev0) -> None:
    """The donating update of a placed state (``_update_leaf``), leaf by
    leaf, each leaf's gradient sums freed once it is updated, then every
    piece of ``step``. Element-wise state: each piece on its own device
    from its gradient box, read only (on one card a replica's ``.to`` is
    the sum itself, which another replica reads too). Blockwise state:
    each box of the leaf on ``dev0`` from the pieces, written back into
    every piece that holds part of it."""
    moments = {n: tree_leaves(opt_state[n]) for n in opt.names}
    blockwise = any(n in _BLOCKWISE_STATE for n in opt.names)
    s0 = step.box((), dev0)
    with torch.no_grad():
        for k, leaf in enumerate(p_leaves):
            if blockwise:
                _update_leaf(opt, s0, _Boxes(list(grads[k].items()), dev0),
                             _Boxes.placed(leaf, dev0),
                             [_Boxes.placed(moments[n][k], dev0) for n in opt.names],
                             leaf.shape)
            else:
                for idx in np.ndindex(leaf.pieces.shape):
                    piece = leaf.pieces[idx]
                    g = grads[k][leaf.bounds(idx)].to(piece.device)
                    _update_leaf(opt, step.pieces[idx], _Boxes.whole(g), _Boxes.whole(piece),
                                 [_Boxes.whole(moments[n][k].pieces[idx]) for n in opt.names],
                                 tuple(piece.shape))
                    del g
            grads[k] = {}
        for t in step.pieces.flat:
            _advance(t)


def _metrics(outs, weights, dev0) -> Dict[str, torch.Tensor]:
    """The step's metrics on ``dev0``: one shard's as they are; over
    shards ``ce`` weighted by each shard's count, the objective summed and
    every other metric the mean (the reference's pmean of aux)."""
    if len(outs) == 1:
        loss, metrics = outs[0]
        return dict(metrics, loss=loss)
    out = {}
    for name in outs[0][1]:
        vals = [m[name].to(dev0) for _, m in outs]
        out[name] = (sum(w.to(dev0) * v for w, v in zip(weights, vals)) if name == "ce"
                     else torch.stack(vals).mean())
    return dict(out, loss=sum(loss.to(dev0) for loss, _ in outs))


def make_sharded_train_step(model: Model, opt: Optimizer, state_shardings, batch_shardings, *,
                            clip_norm: float = 1.0, tensor_parallel: bool = False,
                            donate: bool = False) -> Callable:
    """The port's counterpart of ``jax.jit(make_train_step(model, opt),
    in_shardings=(state_shardings, batch_shardings))``: the same step on a
    train state placed on a mesh, one process driving every device.

    ``state_shardings`` and ``batch_shardings`` are the ``to_named(...)``
    trees the reference hands to ``jit``. The step takes ``(state,
    batch)``, trees of ``Placed`` leaves (a tensor leaf is placed by its
    sharding first) and returns the new state, each piece of the same
    shape, dtype and device as before, and the metrics (``loss``,
    ``grad_norm`` and the model's own) on the mesh's first device.

    - Data shard i (over ("pod", "data"), major first) computes on its
      row of the mesh, under a mesh of its own devices with the data axes
      of size 1. That is the reference's math only where the loss splits
      over the data shards (``data_shards``): an MoE must take its
      expert-parallel branch under the whole mesh, and then takes it per
      shard at the reference's per-shard capacity, in the forward and in
      remat's recompute. Otherwise (an MoE on the local path: no model
      axis, experts that do not divide, too few tokens), and for a batch
      whose dim 0 does not divide over the data axes (left replicated by
      ``batch_spec``), the batch runs as one shard under the whole mesh.
    - The forward and backward read the params by one of two routes. The
      gather route (``tensor_parallel`` False): each leaf whole on the
      shard's first device, so that device computes the model whole and
      the model axis holds pieces for storage and the update only. The
      tensor-parallel route (True), the reference's Megatron split over
      ``model`` for every LM family (dense, moe, vlm, ssm, hybrid and
      audio): each attention, dense-MLP, ``embed`` and ``lm_head`` leaf
      whose spec gives a dim to ``model`` as model shard m's block on the
      row's m-th device (``_tp_axis``; never a split head), so an
      attention (whisper's cross-attention too) runs H / M heads a shard
      and an MLP d_ff / M columns, each row-parallel product an f32
      partial summed in f32 in shard order on the first device
      (``models/layers``), and the embedding and the loss's softmax are
      vocab-parallel (``models/transformer``); each Mamba block's leaves
      as model shard m's slice of its channels (Mamba-1) or heads
      (Mamba-2) wherever they divide M, read from the pieces that hold it
      (``models/ssm``: the activations move between shards, never
      ``in_proj`` or ``out_proj``); every other leaf whole on the first
      device. On both, the MoE expert stacks are model shard m's block on
      the shard's m-th device. The shards run in turn; each one's copy is
      freed after its backward.
    - The loss weights each shard's ce by its share of the count the
      model's loss averages over (``Model.loss_count``: the masked token
      mean's mask) and takes the mean of the rest, so the gradients are
      the batch's; they are summed in f32 in shard order per distinct
      piece on the piece's device (a reduce-scatter; a block's gradient
      covers the pieces in its box), then cast once to the param's dtype.
    - The clip brings each leaf's square sum to the first device in leaf
      order and scales every piece by the one factor.
    - Element-wise optimizer state updates piece by piece on each piece's
      device; blockwise-quantized moments (``v_q``, ``v_scale``) leaf by
      leaf whole on the first device, cut again by their sharding.
    - With ``donate`` the step consumes its input state, as the reference's
      ``jit(..., donate_argnums=(0,))``: every piece of the placed state
      (the given ``Placed`` leaves; a leaf given as a tensor or placed
      otherwise is placed first and only its new pieces are written) gets
      its new values in place, keeping its storage, where jax would delete
      the donated buffers, and the step returns that state: the caller's
      old values are gone. Each leaf updates in boxes of its rows
      (``_update_leaf``): element-wise state piece by piece on each
      piece's device, blockwise state box by box on the first device,
      each written back into the pieces that hold it; ``step`` last. So
      the update holds the state, the gradients and one box's
      temporaries, and the results are the step's without ``donate`` bit
      for bit. Pieces that share storage raise ``ValueError`` before
      anything is written.

    On a (1, 1) mesh it equals ``make_train_step`` bit for bit, and on a
    mesh without a model axis (or one of size 1) the two routes are the
    same step bit for bit.
    """
    mesh = _check_step_meshes(state_shardings, batch_shardings)
    grid, dp_axes = _shard_grid(mesh)
    dev0 = mesh.devices.flat[0]

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        state = _placed({k: state[k] for k in ("params", "opt", "step")},
                        {k: state_shardings[k] for k in ("params", "opt", "step")})
        if donate:
            _check_donation([p for leaf in tree_leaves(state) for p in leaf.pieces.flat])
        batch = _placed(batch, batch_shardings)
        p_leaves, p_struct = tree_flatten(state["params"])
        pieces = [_pieces(leaf) for leaf in p_leaves]
        n = data_shards(model, batch, {k: b.sharding.spec for k, b in batch.items()}, mesh)
        shards = [_shard_batch(batch, dp_axes, n, i, grid[i][0]) for i in range(n)]
        weights = [None]
        if n > 1:
            weights = _loss_weights([model.loss_count(b) for b in shards], dev0)
        acc: List[Dict] = [{} for _ in p_leaves]
        outs = []
        for i in range(n):
            ctx = _row_mesh(mesh, dp_axes, i) if n > 1 else mesh
            loss, metrics, grads = shard_value_and_grad(model, state["params"], shards[i], ctx,
                                                        weight=weights[i], dp=n,
                                                        tensor_parallel=tensor_parallel)
            _accumulate(acc, p_leaves, pieces, grads)
            outs.append((loss, metrics))
            del grads
        grads = _cast(acc, p_leaves)
        gnorm = _clip(grads, clip_norm, dev0)
        metrics = dict(_metrics(outs, weights, dev0), grad_norm=gnorm)
        if donate:
            _update(opt, p_leaves, p_struct, state["opt"], state["step"], grads, dev0, donate)
            return state, metrics
        new_p, new_o = _update(opt, p_leaves, p_struct, state["opt"], state["step"], grads,
                               dev0)
        del grads
        step = state["step"]
        after = np.empty(step.pieces.shape, dtype=object)
        for idx in np.ndindex(after.shape):
            after[idx] = step.pieces[idx] + 1
        new_state = {"params": tree_unflatten(p_struct, new_p), "opt": new_o,
                     "step": shd.Placed(after, step.sharding, step.shape, step.dtype)}
        return new_state, metrics

    return train_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(model: Model, *, window: int = 0) -> Callable:
    def decode_step(params, cache, batch):
        return model.decode(params, cache, batch, window=window)

    return decode_step


# ----------------------------------------------------- the sharded prefill and decode

def _split_cache(live) -> Dict[str, bool]:
    """The cache leaves that a data shard's live params compute one tensor
    a model shard, {name: whether each is its model shard's slice of the
    leaf's ``CACHE_LAYOUT`` split dim}: where an attention's ``wq`` is a
    block leaf, ``k`` and ``v`` (sliced where ``wk`` is one too, else every
    kv head on each shard) and ``pos`` (whole on each); where a Mamba
    block's ``out_proj`` is, its states (sliced by channel or head)."""
    split = {((None,) + path)[-2:] for path, leaf in zip(_leaf_paths(live), tree_leaves(live))
             if isinstance(leaf, _Blocks)}
    out: Dict[str, bool] = {}
    if any(name == "wq" for _, name in split):
        kv = any(name == "wk" for _, name in split)
        out.update(k=kv, v=kv, pos=False)
    if ("mamba", "out_proj") in split:
        out.update(h=True, conv=True, ssm_h=True, ssm_conv=True)
    return out


class _Units:
    """The computing units of one data shard of the sharded prefill and
    decode: model shard m on the row's m-th device for the cache leaves
    ``split`` names (``_split_cache``), the row's first device alone for
    the others; and the box of a cache leaf each unit computes, in the
    whole leaf's coordinates: the shard's rows of the batch dim (every row
    where the batch runs as one shard) and, where ``split`` says the leaf
    is sliced, model shard m's slice of its ``CACHE_LAYOUT`` split dim."""

    def __init__(self, ctx: Mesh, i: int, n: int, split: Dict[str, bool]):
        self.devices = list(_shard_grid(ctx)[0][0])
        self.i, self.n, self.split = i, n, split

    def box(self, name: str, shape, m: Optional[int]) -> Tuple[Tuple[int, int], ...]:
        """Unit m's box of a cache leaf (None: the shard's rows alone)."""
        box = list(_full(shape))
        bd = CACHE_LAYOUT[name].batch
        rows = shape[bd] // self.n
        box[bd] = (self.i * rows, (self.i + 1) * rows)
        if m is not None and self.split.get(name):
            d = CACHE_LAYOUT[name].split
            w = shape[d] // len(self.devices)
            box[d] = (m * w, (m + 1) * w)
        return tuple(box)

    def shape(self, name: str, t: torch.Tensor, B: int) -> Tuple[int, ...]:
        """A cache leaf's whole shape from one unit's tensor: the batch's
        rows on its batch dim, every model shard's slice of a sliced leaf."""
        shape = list(t.shape)
        shape[CACHE_LAYOUT[name].batch] = B
        if self.split.get(name):
            shape[CACHE_LAYOUT[name].split] *= len(self.devices)
        return tuple(shape)

    def sources(self, name: str, shape, leaf) -> List[Tuple[int, Tuple, torch.Tensor]]:
        """[(model shard, box, tensor)] of a cache leaf as the model
        returned it: a list of one tensor a model shard, or one tensor
        computed on the row's first device."""
        if isinstance(leaf, list):
            return [(m, self.box(name, shape, m), t) for m, t in enumerate(leaf)]
        return [(0, self.box(name, shape, None), leaf)]


def _mesh_coords(mesh: Mesh) -> Dict[Tuple[int, ...], Tuple[int, int]]:
    """{mesh index: (data shard, model shard)} of the (dp, mp) grid."""
    grid, _ = _shard_grid(mesh)
    dp, mp = grid.shape
    return {shd.grid_index(mesh, i, m): (i, m) for i in range(dp) for m in range(mp)}


def _pick(sources, own: int):
    """The sources that write a piece of model shard ``own``: where every
    unit holds the same box (a leaf replicated over the model shards) the
    unit of that model shard (its own replica), else all of them."""
    boxes = {box for _, box, _ in sources}
    if len(sources) > 1 and len(boxes) == 1:
        mine = [s for s in sources if s[0] == own]
        return mine or sources[:1]
    return sources


def shard_prefill(model: Model, params, batch: Dict[str, torch.Tensor], mesh: Mesh, i: int = 0,
                  n: int = 1, *, tensor_parallel: bool = False):
    """Data shard ``i`` of ``n``'s prefill, as the sharded step runs it:
    ``params`` read onto data shard 0 of ``mesh`` (the shard's own row, or
    the whole mesh where the batch runs as one shard) without a gradient
    (``_shard_live``), ``model.prefill`` under ``use_mesh(mesh)``. Returns
    (logits, the cache as the model returned it, the shard's ``_Units``);
    the live params are freed on return."""
    live, _ = _shard_live(params, mesh, model.cfg if tensor_parallel else None, grad=False)
    units = _Units(mesh, i, n, _split_cache(live))
    with use_mesh(mesh), torch.no_grad():
        logits, cache = model.prefill(live, batch)
    return logits, cache, units


def make_sharded_prefill_step(model: Model, param_shardings, batch_shardings, *,
                              tensor_parallel: bool = False) -> Callable:
    """The port's counterpart of ``jax.jit(make_prefill_step(model),
    in_shardings=(param_shardings, batch_shardings))``: the prefill on
    params placed on a mesh, one process driving every device.

    The step takes ``(params, batch)`` (``Placed`` leaves; a tensor is
    placed by its sharding first) and returns (logits (B, V) f32 on the
    mesh's first device, cache): the cache a tree of ``Placed`` leaves cut
    by ``to_named(cache_spec(cache_shapes, mesh), mesh)``, each piece
    built on its own device from the units that computed it (never the
    whole cache put together on one device).

    Data shards and routes are ``make_sharded_train_step``'s, without a
    gradient (``shard_prefill``): data shard i runs its rows on its row
    of the mesh under a mesh of its own (the batch whole under the whole
    mesh where ``data_shards`` says it does not split); the gather route
    reads each leaf whole on the shard's first device; the
    tensor-parallel route splits the attention, MLP and Mamba blocks over
    the model shards for every LM family, so model shard m computes its
    heads' k and v (``layers._attention_split``: row 7 on its heads under
    the flash gate) or its channels' or heads' SSM states (``models/ssm``)
    and its pieces of the cache come from them (``_Units``), and the head
    is vocab-parallel. On a (1, 1) mesh it equals ``make_prefill_step`` bit
    for bit, and on a mesh without a model axis the two routes are the
    same step bit for bit."""
    mesh = _check_step_meshes(param_shardings, batch_shardings)
    grid, dp_axes = _shard_grid(mesh)
    dev0 = mesh.devices.flat[0]

    def prefill_step(params, batch):
        params = _placed(params, param_shardings)
        batch = _placed(batch, batch_shardings)
        n = data_shards(model, batch, {k: b.sharding.spec for k, b in batch.items()}, mesh)
        B = next(iter(batch.values())).shape[0]
        logits, shards = [], []
        for i in range(n):
            ctx = _row_mesh(mesh, dp_axes, i) if n > 1 else mesh
            lg, cache, units = shard_prefill(model, params,
                                             _shard_batch(batch, dp_axes, n, i, grid[i][0]),
                                             ctx, i, n, tensor_parallel=tensor_parallel)
            logits.append(lg.to(dev0))
            shards.append((units, cache))
        out = {}
        for name, leaf in shards[0][1].items():
            first = leaf[0] if isinstance(leaf, list) else leaf
            shape = shards[0][0].shape(name, first, B)
            sources = [src for u, c in shards for src in u.sources(name, shape, c[name])]
            spec = shd.cache_spec({name: torch.empty(shape, dtype=first.dtype, device="meta")},
                                  mesh)[name]
            out[name] = _build_pieces(sources, shd.NamedSharding(mesh, spec), shape)
            for _, c in shards:
                c[name] = None  # each shard's tensors freed once its pieces are built
        return torch.cat(logits) if n > 1 else logits[0], out

    return prefill_step


def _build_pieces(sources, sharding: shd.NamedSharding, shape) -> shd.Placed:
    """A ``Placed`` of ``shape`` cut by ``sharding`` out of the units'
    (model shard, box, tensor) sources: each piece a new tensor on its
    device, copied from the unit of its own model shard first (a replica
    from its own shard's computation)."""
    mesh = sharding.mesh
    coords = _mesh_coords(mesh)
    pieces = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(pieces.shape):
        own = coords.get(idx, (0, 0))[1]
        srcs = sorted(sources, key=lambda src: src[0] != own)
        pieces[idx] = shd.assemble([(box, t) for _, box, t in srcs],
                                   sharding.bounds(shape, idx),
                                   mesh.devices[idx], srcs[0][2].dtype)
    return shd.from_pieces(pieces, sharding, shape)


def grow_placed_cache(model: Model, cache: Dict[str, shd.Placed], new_len: int):
    """``model.grow_cache`` of a cache of ``Placed`` leaves (the sharded
    prefill's): a leaf grows piece by piece on each piece's device where
    ``cache_spec`` of the grown shapes gives it its spec again and every
    piece spans its slot dim whole; any other grown leaf is put together,
    grown and placed by ``cache_spec`` of the grown shapes; a leaf that
    does not grow comes back as it is."""
    mesh = _mesh_of({k: v.sharding for k, v in cache.items()})
    grown = model.grow_cache({k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                              for k, v in cache.items()}, new_len)
    specs = shd.cache_spec(grown, mesh)
    out = {}
    for name, leaf in cache.items():
        shape = tuple(grown[name].shape)
        ax = CACHE_LAYOUT[name].slots
        if shape == tuple(leaf.shape):
            out[name] = leaf
        elif leaf.sharding.spec == specs[name] and all(
                leaf.bounds(idx)[ax] == (0, leaf.shape[ax])
                for idx in np.ndindex(leaf.pieces.shape)):
            pieces = np.empty(leaf.pieces.shape, dtype=object)
            for idx in np.ndindex(pieces.shape):
                pieces[idx] = model.grow_cache({name: leaf.pieces[idx]}, new_len)[name]
            out[name] = shd.from_pieces(pieces, leaf.sharding, shape)
        else:
            whole = model.grow_cache({name: shd.gather(leaf)}, new_len)[name]
            out[name] = shd.place(whole, shd.NamedSharding(mesh, specs[name]))
    return out


def shard_decode(model: Model, params, cache: Dict[str, shd.Placed],
                 batch: Dict[str, torch.Tensor], mesh: Mesh, i: int = 0, n: int = 1, *,
                 window: int = 0, tensor_parallel: bool = False):
    """Data shard ``i`` of ``n``'s decode step, as the sharded step runs
    it: ``params`` read onto its row of ``mesh`` without a gradient, each
    unit's box of each cache leaf (``_Units``) read from the placed
    ``cache`` (its own piece ``Placed.piece(i, m)`` in place where it is
    that box on the unit's device, else a copy, span ``cache_copy``), and
    ``model.decode`` under the shard's mesh (its row, or the whole mesh
    where the batch runs as one shard). Returns (logits, {leaf: [(model
    shard, box, tensor)]}), the tensors the step wrote."""
    grid, dp_axes = _shard_grid(mesh)
    ctx = _row_mesh(mesh, dp_axes, i) if n > 1 else mesh
    live, _ = _shard_live(params, ctx, model.cfg if tensor_parallel else None, grad=False)
    units = _Units(ctx, i, n, _split_cache(live))
    local, held = {}, {}
    for name, leaf in cache.items():
        held[name] = []
        each = name in units.split  # one tensor a model shard
        for m in range(len(units.devices)) if each else [None]:
            dev = units.devices[m or 0]
            want = units.box(name, leaf.shape, m)
            bounds, piece = leaf.piece(i, m or 0)
            if bounds == want and piece.device == torch.device(dev):
                t = piece
            else:  # a copy of the box; the pieces stay where they are
                nbytes = math.prod(b - a for a, b in want) * piece.element_size()
                with obs.span("cache_copy", leaf=name, unit=m, bytes=nbytes):
                    t = shd.assemble([(leaf.bounds(j), leaf.pieces[j])
                                      for j in np.ndindex(leaf.pieces.shape)],
                                     want, dev, leaf.dtype)
            held[name].append((m or 0, want, t))
        local[name] = [t for _, _, t in held[name]] if each else held[name][0][2]
    with use_mesh(ctx):
        logits, _ = model.decode(live, local, batch, window=window)
    return logits, held


def _write_back(cache: Dict[str, shd.Placed], held, pos: torch.Tensor, row0: int,
                coords) -> None:
    """After a data shard's decode: every piece that holds part of what a
    unit wrote into a copy gets it in place, the token's slot of ``k``,
    ``v`` and ``pos`` (``pos`` the shard's positions from global row
    ``row0``) or the whole box of the state; each replica from the unit of
    its own model shard (``_pick``). ``enc_out`` is only read."""
    for name, leaf in cache.items():
        if CACHE_LAYOUT[name].kind == "read":
            continue
        for idx in np.ndindex(leaf.pieces.shape):
            dst, db = leaf.pieces[idx], leaf.bounds(idx)
            for _, box, src in _pick(held[name], coords.get(idx, (0, 0))[1]):
                if src is dst:
                    continue
                if CACHE_LAYOUT[name].kind == "slot":
                    _write_slots(dst, db, src, box, pos, row0)
                else:
                    _copy_box(dst, db, src, box)


def _write_slots(dst, db, src, sb, pos_rows, row0: int) -> None:
    """Slot ``pos % W`` of each row of ``src`` (box ``sb``, every slot of
    dim 2) that ``dst`` (box ``db``) holds, written into ``dst`` in place:
    a row whose slot lies in another piece keeps its old value.
    ``pos_rows`` are the positions of the rows from global row ``row0``."""
    r0, r1 = max(db[1][0], sb[1][0]), min(db[1][1], sb[1][1])
    rest = [(max(a[0], b[0]), min(a[1], b[1])) for a, b in zip(db[3:], sb[3:])]
    l0, l1 = max(db[0][0], sb[0][0]), min(db[0][1], sb[0][1])
    if r0 >= r1 or l0 >= l1 or any(a >= b for a, b in rest):
        return
    slot = pos_rows[r0 - row0:r1 - row0].long() % src.shape[2]
    local = slot.to(dst.device) - db[2][0]
    ok = (local >= 0) & (local < dst.shape[2])
    local = local.clamp(0, dst.shape[2] - 1)
    d_rest = tuple(slice(a - s, b - s) for (a, b), (s, _) in zip(rest, db[3:]))
    s_rest = tuple(slice(a - s, b - s) for (a, b), (s, _) in zip(rest, sb[3:]))
    d_rows = torch.arange(r0 - db[1][0], r1 - db[1][0], device=dst.device)
    s_rows = torch.arange(r0 - sb[1][0], r1 - sb[1][0], device=src.device)
    where = (slice(l0 - db[0][0], l1 - db[0][0]), d_rows, local) + d_rest
    new = src[(slice(l0 - sb[0][0], l1 - sb[0][0]), s_rows, slot.to(src.device)) + s_rest]
    mask = ok.reshape((1, -1) + (1,) * len(rest))
    dst[where] = torch.where(mask, new.to(dst.device), dst[where])


def _copy_box(dst, db, src, sb) -> None:
    """The part of ``src`` (box ``sb``) that ``dst`` (box ``db``) holds,
    copied into ``dst`` in place."""
    inter = [(max(a[0], b[0]), min(a[1], b[1])) for a, b in zip(db, sb)]
    if any(a >= b for a, b in inter):
        return
    dst[tuple(slice(a - s, b - s) for (a, b), (s, _) in zip(inter, db))].copy_(
        src[tuple(slice(a - s, b - s) for (a, b), (s, _) in zip(inter, sb))])


def make_sharded_decode_step(model: Model, param_shardings, cache_shardings, batch_shardings, *,
                             window: int = 0, tensor_parallel: bool = False) -> Callable:
    """The port's counterpart of ``jax.jit(make_decode_step(model,
    window=window), in_shardings=(param_shardings, cache_shardings,
    batch_shardings), donate_argnums=(1,))``: one token against a cache
    placed by ``cache_spec``.

    The step takes ``(params, cache, batch)`` (``Placed`` leaves; a tensor,
    or a leaf placed otherwise, is placed by its sharding first) and
    returns (logits (B, V) f32 on the mesh's first device, the same cache
    tree): the donation is an update in place, each piece written where
    it is. Data shards and routes are ``make_sharded_prefill_step``'s
    (``shard_decode``). A unit (model shard m of data shard i for the
    cache leaves the tensor-parallel route computes a model shard each,
    ``_split_cache``, else the shard's first device) whose box of a leaf
    is its own piece decodes into that piece in place (the Mamba-1
    states, a split attention's k and v); any other box (a batch that
    runs as one shard over a cache split over data, a ring whose W dim
    ``cache_spec`` split because B does not divide, the gather route's kv
    heads or SSM channels split over ``model``, the hybrid's head-split
    ``ssm_h`` whose pieces ``cache_spec`` cuts on P) is read into a copy
    (span ``cache_copy``), and after the shard's step the token's slot
    (``k``, ``v``, ``pos``), or the whole box (the ssm state), is written
    back into every piece that holds part of it, each replica from its
    own model shard (``_write_back``)."""
    mesh = _check_step_meshes(param_shardings, cache_shardings, batch_shardings)
    grid, dp_axes = _shard_grid(mesh)
    dev0 = mesh.devices.flat[0]

    def decode_step(params, given, batch):
        params = _placed(params, param_shardings)
        cache = _placed(given, cache_shardings)
        if all(a is b for a, b in zip(tree_leaves(given), tree_leaves(cache))):
            cache = given
        batch = _placed(batch, batch_shardings)
        n = data_shards(model, batch, {k: b.sharding.spec for k, b in batch.items()}, mesh)
        coords = _mesh_coords(mesh)
        logits = []
        for i in range(n):
            sb = _shard_batch(batch, dp_axes, n, i, grid[i][0])
            lg, held = shard_decode(model, params, cache, sb, mesh, i, n, window=window,
                                    tensor_parallel=tensor_parallel)
            logits.append(lg.to(dev0))
            _write_back(cache, held, sb["pos"], i * sb["pos"].shape[0], coords)
            del held
        return torch.cat(logits) if n > 1 else logits[0], cache

    return decode_step
