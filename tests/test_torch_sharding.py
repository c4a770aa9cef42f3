"""The port's model-zoo mesh against the reference, on the CPU: the pod
meshes, the ambient mesh, the sharding specs, the input shapes, the dry
run's analytic terms, and the placement that cuts a tree by its specs.

- Specs: for every assigned arch at full width, on the meshes (16, 16),
  (2, 16, 16), (2, 4) and (1, 1), the port's ``tree_param_specs`` of its
  meta-tensor params and AdamW state, ``batch_spec`` of every input shape
  and ``cache_spec`` at decode_32k equal the reference's leaf for leaf and
  entry for entry. The reference side runs on ``jax.eval_shape`` trees and
  a duck-typed mesh: its ``_axis_size`` reads only ``axis_names`` and
  ``devices.shape``, so no forced devices are needed.
- ``Model.input_spec`` shapes and dtypes, ``model_flops`` and
  ``active_params`` equal the reference's exactly.
- ``place`` and ``gather`` round-trip bit for bit on eight CPU shards, and
  each device holds the bytes the specs reckon.
- ``dryrun_one`` runs a train and a decode combination on meta tensors.
"""

import functools
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.all_archs  # noqa: F401  (registers the reference's archs)
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import get_arch as jget_arch
from repro.launch import dryrun as jdry
from repro.launch import sharding as jshd
from repro.launch.steps import train_state_shapes as j_state_shapes
from repro.models.registry import build_model as jbuild
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch import convert, obs, util
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import steps as tsteps
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.launch.steps import init_train_state
from repro_torch.launch.steps import train_state_shapes as t_state_shapes
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw

ARCHS = tconfigs.ASSIGNED_ARCHS
MESHES = [(16, 16), (2, 16, 16), (2, 4), (1, 1)]


def _axes(dims):
    return ("pod", "data", "model") if len(dims) == 3 else ("data", "model")


def _meshes(dims):
    ref = types.SimpleNamespace(axis_names=_axes(dims), devices=np.empty(dims))
    port = tmesh.make_mesh(dims, _axes(dims), devices=["meta"] * math.prod(dims))
    return ref, port


def _spec_leaves(tree, path=()):
    """(path, spec as a plain tuple) in sorted-key order; a spec is a tuple
    in both packages, so it is a leaf here."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, (jshd.P, tshd.P)):
        return [x for i, v in enumerate(tree) for x in _spec_leaves(v, path + (i,))]
    return [(path, tuple(tree))]


@functools.lru_cache(maxsize=None)
def _ref(arch):
    model = jbuild(jget_arch(arch))
    state = j_state_shapes(model, jadamw(1e-4))
    cache = jax.eval_shape(lambda: model.init_cache(128, 32_768))
    return model, state, cache


@functools.lru_cache(maxsize=None)
def _port(arch):
    model = tbuild(tconfigs.get_arch(arch))
    state = t_state_shapes(model, tadamw(1e-4))
    cache = model.init_cache(128, 32_768, "meta")
    return model, state, cache


def _same(a, b):
    la, lb = _spec_leaves(a), _spec_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x == y, (path, x, y)
    return len(la)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, dims):
    jm, jstate, jcache = _ref(arch)
    tm, tstate, tcache = _port(arch)
    rmesh, pmesh = _meshes(dims)
    kv = jm.cfg.n_kv_heads
    n = _same(jshd.tree_param_specs(jstate["params"], rmesh, n_kv_heads=kv),
              tshd.tree_param_specs(tstate["params"], pmesh, n_kv_heads=kv))
    assert n > 5
    for k in jstate["opt"]:
        _same(jshd.tree_param_specs(jstate["opt"][k], rmesh, n_kv_heads=kv),
              tshd.tree_param_specs(tstate["opt"][k], pmesh, n_kv_heads=kv))
    for name, shape in J_SHAPES.items():
        jb = jshd.batch_spec(jm.input_spec(shape), rmesh)
        tb = tshd.batch_spec(tm.input_spec(tconfigs.INPUT_SHAPES[name]), pmesh)
        _same(jb, tb)
    _same(jshd.cache_spec(jcache, rmesh), tshd.cache_spec(tcache, pmesh))
    # some leaf is sharded on every mesh with a model axis of 16
    if dims[-1] == 16:
        specs = tshd.tree_param_specs(tstate["params"], pmesh, n_kv_heads=kv)
        assert any("model" in s for _, s in _spec_leaves(specs))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_spec_flops_and_active_params_equal_the_reference(arch):
    jm, jstate, _ = _ref(arch)
    tm, tstate, _ = _port(arch)
    for name, shape in J_SHAPES.items():
        assert tconfigs.INPUT_SHAPES[name] == tconfigs.InputShape(
            shape.name, shape.seq_len, shape.global_batch, shape.kind)
        js, ts = jm.input_spec(shape), tm.input_spec(tconfigs.INPUT_SHAPES[name])
        assert list(js) == list(ts)
        for k in js:
            assert tuple(ts[k].shape) == js[k].shape and ts[k].is_meta, (name, k)
            assert str(ts[k].dtype).removeprefix("torch.") == jnp.dtype(js[k].dtype).name
        n = sum(x.size for x in jax.tree.leaves(jstate["params"]))
        assert util.tree_size(tstate["params"]) == n
        assert tdry.active_params(tm.cfg, n) == jdry.active_params(jm.cfg, n)
        assert tdry.model_flops(tm.cfg, tconfigs.INPUT_SHAPES[name], n,
                                tdry.active_params(tm.cfg, n)) == jdry.model_flops(
            jm.cfg, shape, n, jdry.active_params(jm.cfg, n))


def test_input_shapes_equal_the_reference():
    assert list(tconfigs.INPUT_SHAPES) == list(J_SHAPES)
    for name, s in J_SHAPES.items():
        t = tconfigs.INPUT_SHAPES[name]
        assert (t.name, t.seq_len, t.global_batch, t.kind) == (
            s.name, s.seq_len, s.global_batch, s.kind)
    assert tdry.LONG_SKIP == jdry.LONG_SKIP


def test_ds2_input_spec_equals_the_reference():
    jm = jbuild(jget_arch("deepspeech2"))
    tm = tbuild(tconfigs.get_arch("deepspeech2"))
    for name, shape in J_SHAPES.items():
        js, ts = jm.input_spec(shape), tm.input_spec(tconfigs.INPUT_SHAPES[name])
        assert {k: tuple(v.shape) for k, v in ts.items()} == {k: v.shape for k, v in js.items()}


# ---------------------------------------------------------------- meshes


def test_make_mesh_shapes_axes_and_devices():
    m = tmesh.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    assert m.axis_names == ("data", "model") and m.axis_sizes == (2, 4)
    assert m.shape == {"data": 2, "model": 4} and not m.empty
    assert m.devices.shape == (2, 4) and m.devices[1, 3] == torch.device("cpu")
    meta = tmesh.make_mesh((2, 16, 16), ("pod", "data", "model"), devices=["meta"] * 512)
    assert meta.devices.shape == (2, 16, 16) and meta.devices[0, 0, 0].type == "meta"
    with pytest.raises(ValueError):
        tmesh.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 7)
    with pytest.raises(ValueError):
        tmesh.make_mesh((2, 4), ("data",), devices=["cpu"] * 8)


def test_meshes_over_cards_raise_without_enough_cards():
    # the reference's contract on 8 devices (tests/test_distributed.py):
    # the production meshes do not fit, and raise ValueError
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for multi_pod in (False, True):
        with pytest.raises(ValueError):
            tmesh.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(ValueError):
        tmesh.make_mesh((1, cards + 1), ("data", "model"))
    if cards == 0:
        with pytest.raises(RuntimeError):  # the default device is the card
            tmesh.make_host_mesh()
    else:
        assert tmesh.make_host_mesh().devices.shape == (1, 1)


def test_use_mesh_nests_and_restores_the_outer_mesh():
    a = tmesh.make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    b = tmesh.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    assert util.get_abstract_mesh().empty
    assert util.get_abstract_mesh().axis_names == () and util.get_abstract_mesh().axis_sizes == ()
    with util.use_mesh(a):
        assert util.get_abstract_mesh() is a
        with util.use_mesh(b):
            assert util.get_abstract_mesh() is b
            assert util.get_abstract_mesh().axis_sizes == (2, 4)
        assert util.get_abstract_mesh() is a
    assert util.get_abstract_mesh().empty and util._MESH_STACK == []
    with pytest.raises(KeyError):
        with util.use_mesh(b):
            raise KeyError("inside")
    assert util.get_abstract_mesh().empty


def test_card_constants_are_the_h100s():
    assert tmesh.CARD_HBM_BYTES_PER_S == 3.35e12 and tmesh.CARD_BF16_FLOPS == 989e12
    assert tmesh.CARD_F32_FLOPS == 67e12 and tmesh.CARD_HBM_BYTES == 80 * 10**9


# ---------------------------------------------------------------- placement


@functools.lru_cache(maxsize=None)
def _small_state(arch, seed=0):
    cfg = jget_arch(arch).reduced()
    jm = jbuild(cfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    tcfg = tconfigs.get_arch(arch).reduced()
    tm = tbuild(tcfg)
    gen = torch.Generator().manual_seed(seed)
    state = init_train_state(tm, tadamw(1e-3), gen)
    state["params"] = convert.params_from_numpy(jp, "cpu")
    return tcfg, state


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32) \
        if t.element_size() == 4 else t


@pytest.mark.parametrize("dims", [(2, 4), (2, 2, 2), (1, 8), (8, 1)],
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("arch", ["qwen3-8b", "kimi-k2-1t-a32b", "zamba2-2.7b"])
def test_place_and_gather_round_trip_bit_for_bit(arch, dims):
    cfg, state = _small_state(arch)
    mesh = tmesh.make_mesh(dims, _axes(dims), devices=["cpu"] * 8)
    tree = {"params": state["params"], "opt": state["opt"]}
    specs = {"params": tshd.tree_param_specs(tree["params"], mesh, n_kv_heads=cfg.n_kv_heads),
             "opt": {k: tshd.tree_param_specs(v, mesh, n_kv_heads=cfg.n_kv_heads)
                     for k, v in tree["opt"].items()}}
    placed = tshd.place(tree, tshd.to_named(specs, mesh))
    back = tshd.gather(placed)
    la, lb = _spec_leaves(tree), _spec_leaves(back)
    assert [p for p, _ in la] == [p for p, _ in lb]
    from repro_torch.core.tree import tree_leaves

    sharded = 0
    for a, b, p in zip(tree_leaves(tree), tree_leaves(back), tree_leaves(placed)):
        assert b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(_bits(b), _bits(a))
        assert p.pieces.shape == dims
        sharded += any(x != tuple(a.shape) for x in (tuple(q.shape) for q in p.pieces.flat))
        # every piece is its own tensor: writing one leaves the leaf alone
        assert all(q.untyped_storage().data_ptr() != a.untyped_storage().data_ptr()
                   for q in p.pieces.flat)
    if math.prod(dims[-1:]) > 1 or dims[0] > 1:
        assert sharded > 0
    want = tshd.tree_spec_nbytes(tree, specs, mesh)
    per_device = tshd.device_nbytes(placed)
    assert per_device.shape == dims and (per_device == want).all()


def test_placed_block_is_the_piece_or_an_all_gather():
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    w = torch.arange(8 * 6 * 5, dtype=torch.float32).reshape(8, 6, 5)
    # an expert stack: experts over model, rows over data
    placed = tshd.place(w, tshd.NamedSharding(mesh, tshd.P("model", "data", None)))
    assert placed.pieces[1, 2].shape == (2, 3, 5)
    blk = placed.block((4, 6), "cpu")  # model shard 2, gathered over data
    assert torch.equal(blk, w[4:6])
    whole = tshd.place(w, tshd.NamedSharding(mesh, tshd.P("model", None, None)))
    assert whole.block((2, 4), "cpu") is whole.pieces[0, 1]
    assert torch.equal(tshd.gather(whole), w)


# ---------------------------------------------------------------- the dry run


# the tensor-parallel blocks a decode step runs a layer, where they split
# over the production mesh's 16 model shards (whisper's 6 heads do not)
_DRY_TP_KINDS = {"qwen3-8b": {"attn_decode", "mlp"}, "falcon-mamba-7b": {"mamba1_decode"},
                 "zamba2-2.7b": {"mamba2_decode", "attn_decode", "mlp"}, "whisper-tiny": {"mlp"}}


@pytest.mark.parametrize("arch,shape", [("whisper-tiny", "train_4k"),
                                        ("qwen3-8b", "decode_32k"),
                                        ("falcon-mamba-7b", "long_500k"),
                                        ("zamba2-2.7b", "decode_32k"),
                                        ("whisper-tiny", "decode_32k")])
def test_dryrun_one_runs_on_meta_tensors(arch, shape):
    """The combo runs on meta tensors; a decode shape on the
    tensor-parallel route (each block's span on 16 model shards, every
    block leaf 1 / 16 of its leaf); the bytes a device are the specs'."""
    with obs.enabled() as tracer:
        rec = tdry.dryrun_one(arch, shape)
    assert rec["status"] == "ok", rec.get("error")
    spans = [e.args for e in tracer.events if e.name == "tensor_parallel"]
    if shape == "train_4k":
        assert not spans
    else:
        assert {s["kind"] for s in spans} == _DRY_TP_KINDS[arch]
        assert all(s["mp"] == 16 for s in spans)
        model = tbuild(tconfigs.get_arch(arch))
        params = model.init(None, "meta")
        mesh = tmesh.make_mesh((16, 16), ("data", "model"), devices=["meta"] * 256)
        row = tmesh.make_mesh((1, 16), ("data", "model"), devices=["meta"] * 16)
        live, _ = tsteps._shard_live(params, row, model.cfg, grad=False)
        leaves = dict(zip(tsteps._leaf_paths(params), tree_leaves(params)))
        split = {p: leaf for p, leaf in zip(tsteps._leaf_paths(live), tree_leaves(live))
                 if isinstance(leaf, tsteps._Blocks)}
        assert split and all(b.numel() * 16 == leaves[p].numel()
                             for p, leaf in split.items() for b in leaf.blocks)
        specs = tshd.tree_param_specs(params, mesh, n_kv_heads=model.cfg.n_kv_heads)
        assert rec["bytes_params"] == tshd.tree_spec_nbytes(params, specs, mesh)
        cache = model.init_cache(tconfigs.INPUT_SHAPES[shape].global_batch, rec["cache_len"],
                                 "meta")
        assert rec["bytes_cache"] == tshd.tree_spec_nbytes(cache, tshd.cache_spec(cache, mesh),
                                                           mesh)
    cfg = tconfigs.get_arch(arch)
    n = rec["n_params"]
    assert rec["model_flops"] == tdry.model_flops(cfg, tconfigs.INPUT_SHAPES[shape], n,
                                                  rec["n_active_params"])
    assert rec["mesh"] == "16x16" and rec["bytes_per_device"] > rec["bytes_params"] > 0
    assert rec["t_compute_s"] == rec["model_flops"] / 256 / tmesh.CARD_BF16_FLOPS
    assert rec["t_memory_s"] == rec["bytes_per_device"] / tmesh.CARD_HBM_BYTES_PER_S
    assert rec["fits_card"] == (rec["bytes_per_device"] <= tmesh.CARD_HBM_BYTES)
    if shape == "train_4k":
        assert rec["bytes_opt"] > 0 and rec["bytes_cache"] == 0
        # the donated train state: params, moments and step, by the specs
        model = tbuild(cfg)
        state = tsteps.train_state_shapes(model, tadamw(1e-4))
        mesh = tmesh.make_mesh((16, 16), ("data", "model"), devices=["meta"] * 256)
        specs = {"params": tshd.tree_param_specs(state["params"], mesh,
                                                 n_kv_heads=cfg.n_kv_heads),
                 "opt": {k: tshd.tree_param_specs(v, mesh, n_kv_heads=cfg.n_kv_heads)
                         for k, v in state["opt"].items()}, "step": tshd.P()}
        assert rec["alias_size_in_bytes"] == tshd.tree_spec_nbytes(state, specs, mesh) == (
            rec["bytes_params"] + rec["bytes_opt"] + 4)
    else:
        assert rec["bytes_cache"] > 0 and "cache_len" in rec
        assert rec["alias_size_in_bytes"] == rec["bytes_cache"]


def test_dryrun_cli_appends_records(tmp_path):
    out = tmp_path / "dry.json"
    tdry.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--out", str(out)])
    tdry.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--out", str(out)])
    recs = json.loads(out.read_text())
    assert len(recs) == 1 and recs[0]["status"] == "ok" and recs[0]["window"] == 0


def test_dryrun_reports_a_failure_in_the_record(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no such step")

    monkeypatch.setattr(tdry, "shard_decode", boom)
    rec = tdry.dryrun_one("stablelm-1.6b", "decode_32k", multi_pod=True)
    assert rec["status"] == "error" and "no such step" in rec["error"]
    assert rec["mesh"] == "2x16x16"
