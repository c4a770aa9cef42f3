"""The sharded train step's tensor-parallel route
(``launch.steps.make_sharded_train_step(..., tensor_parallel=True)``) on
the CPU: meshes of repeated ``"cpu"`` devices, one process driving every
shard, as ``tests/test_torch_sharded_train.py`` runs the gather route.

What it must equal:

- on a mesh without a model axis ((1, 1), (2, 1)), the gather route bit
  for bit: there are no blocks;
- on a mesh with one, the port's unsharded step under ``use_mesh`` of the
  same mesh, within the gather route's tolerances (below);
- the reference's own sharded step, ``jax.jit(make_train_step,
  in_shardings=...)`` on a (2, 4) mesh of 8 forced host devices (qwen3-8b
  reduced, as ``tests/test_distributed.py`` runs it), within the same
  tolerances.

Tolerances are ``tests/test_torch_sharded_train.py``'s (f32; each worst
leaf's ``max |a - b| / max |b|``): metrics rtol 1e-6, f32 moments 1e-5,
params 1e-3 over the elements whose gradient is informative (the elements
whose reference ``|m|`` is rounding noise, at most 1%, held to one Adam
step's move). Readings of the tensor-parallel route over every case here:
metrics up to 2.3e-7, moments up to 3.3e-6, informative params up to
5.0e-6, set aside up to 0.19% of the elements and 0.11 of a step's move
(the row-parallel sums and the vocab-parallel softmax add in another
order; Adam's first step carries that into params whose gradient is
noise: read over every element, 1.03e-3 to 1.72e-3 on some CPUs). The
planted fault (model shard 1's partial dropped from every row-parallel
sum, ``layers._row_sum``) reads grad norms 4.6e-2 to 0.15 apart, losses
7.0e-3 to 1.7e-2, informative params 2.2e-2 to 2.3e-2 and moments 1.2 and
more. The reference's own test allows 1e-2 (loss, absolute) and 5e-2
(params, absolute): the port's route reads 4.8e-7 and 5.5e-5 against the
reference's jitted step, 2e4 and 900 times inside.

One leaf is held apart: the attention's key bias (``bk``, the vlm
family), whose gradient is zero but for rounding (a bias added to every
key shifts each query's scores by one constant, which the softmax
cancels). Adam's first step divides it by its own root, so it moves by a
rounding-determined fraction of the learning rate either way: it is held
to a tenth of the learning rate, absolute (readings 0.015 and 0.017 of
it).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _multidevice import run_multidevice
from repro_torch import convert, obs
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.optim import adamw
from test_torch_sharded_train import (_CHILD, METRIC_RTOL, PARAM_RTOL, _assert_layout, _batch, _bits_equal,
                                      _mesh, _nest, _setup, _shardings, _unsharded, _within)

LR = 1e-3
BK_ABS = 0.1 * LR

TP_MESHES = [((1, 2), ("data", "model")), ((1, 4), ("data", "model")),
             ((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
             ((2, 2, 2), ("pod", "data", "model"))]
TP_IDS = ["1x2", "1x4", "2x2", "2x4", "2x2x2"]
TP_ARCHS = [("qwen3-8b", {}), ("stablelm-1.6b", {"remat": True}), ("kimi-k2-1t-a32b", {"remat": True})]
TP_ARCH_IDS = ["qwen3", "stablelm_remat", "kimi_remat"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (as ``tests/test_torch_sharded_train.py``: the
    step's many small ops otherwise wait on the thread pool's barriers
    beside the suite's other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("tensor_parallel")
    run_multidevice(f"CASES = {[('qwen3', 'qwen3-8b', {}, False)]!r}\nOUT = {str(out)!r}\n"
                    + _CHILD)
    return out


# ---------------------------------------------------------------- helpers


def _step(model, opt, state, batch, mesh, cfg, tp=True, s_sh=None):
    """One sharded step (the reference's specs unless ``s_sh``): (new
    state, metrics, the ``tensor_parallel`` spans' args)."""
    specs, b_sh = _shardings(cfg, state, batch, mesh)
    s_sh = specs if s_sh is None else s_sh
    with obs.enabled() as tracer:
        new, met = steps.make_sharded_train_step(model, opt, s_sh, b_sh,
                                                 tensor_parallel=tp)(state, batch)
    return new, met, [e.args for e in tracer.events if e.name == "tensor_parallel"]


def _live(cfg, state, mesh, batch):
    """Data shard 0's live tree on the tensor-parallel route, and its
    (leaf index, box, tensor) list."""
    s_sh, _ = _shardings(cfg, state, batch, mesh)
    placed = steps._placed(state["params"], s_sh["params"])
    return steps._shard_live(placed, mesh, cfg)


def _split(tree) -> dict:
    """{leaf path: block leaf} of a live tree."""
    leaves, _ = tree_flatten(tree)
    return {"/".join(p): leaf for p, leaf in zip(steps._leaf_paths(tree), leaves)
            if isinstance(leaf, steps._Blocks)}


class _DropPartial:
    """Planted fault: model shard ``k``'s partial left out of every
    row-parallel sum (``layers._row_sum``)."""

    def __init__(self, monkeypatch, k=1):
        self.calls, real = 0, tL._row_sum

        def row_sum(partials, home, dtype):
            self.calls += 1
            return real([p for m, p in enumerate(partials) if m != k], home, dtype)

        monkeypatch.setattr(tL, "_row_sum", row_sum)


def _kinds(cfg) -> int:
    """Tensor-parallel blocks a layer: the attention, and the MLP of a
    dense model (an MoE's experts take the expert-parallel branch)."""
    return 1 if cfg.n_experts else 2


# -------------------------------------------------------------- the spec helper


def test_model_dim_reads_the_split_dim_off_the_spec():
    assert shd.model_dim(shd.P(None, "data", "model"), 3) == 2
    assert shd.model_dim(shd.P("model", "data"), 2) == 0
    assert shd.model_dim(shd.P(None, ("pod", "data")), 2) is None
    assert shd.model_dim(shd.P(("data", "model")), 1) == 0
    assert shd.model_dim(shd.P(), 2) is None


# ------------------------------------------------- no model axis: the gather route


@pytest.mark.parametrize("dims", [(1, 1), (2, 1)], ids=["1x1", "2x1"])
@pytest.mark.parametrize("arch,kw", [("qwen3-8b", {}), ("kimi-k2-1t-a32b", {"remat": True})],
                         ids=["qwen3", "kimi_remat"])
def test_without_a_model_axis_it_is_the_gather_route_bit_for_bit(arch, kw, dims):
    cfg, model, opt, state, mesh = _setup(arch, dims, ("data", "model"), **kw)
    batch = _batch(cfg)
    new, met, spans = _step(model, opt, state, batch, mesh, cfg)
    want, want_m, _ = _step(model, opt, state, batch, mesh, cfg, tp=False)
    assert not spans
    for a, b in zip(tree_leaves(shd.gather(new)), tree_leaves(shd.gather(want))):
        assert _bits_equal(a, b)
    assert all(_bits_equal(met[k], want_m[k]) for k in want_m)


# ------------------------------------------------- against the unsharded step


@pytest.mark.parametrize("dims,axes", TP_MESHES, ids=TP_IDS)
@pytest.mark.parametrize("arch,kw", TP_ARCHS, ids=TP_ARCH_IDS)
def test_tensor_parallel_step_matches_the_unsharded_step(arch, kw, dims, axes):
    """Within the gather route's tolerances; the attention (and a dense
    model's MLP) take one ``tensor_parallel`` span a layer a data shard,
    twice with remat (its recompute in the backward); the new pieces keep
    their shapes, dtypes and devices, and each device's bytes are the
    specs'."""
    cfg, model, opt, state, mesh = _setup(arch, dims, axes, **kw)
    batch = _batch(cfg)
    s_sh, _ = _shardings(cfg, state, batch, mesh)
    new, met, spans = _step(model, opt, state, batch, mesh, cfg, s_sh=s_sh)
    want, want_m = _unsharded(model, opt, state, batch, mesh)
    ok, r, rm = _within(shd.gather(new), want, met, want_m)
    assert ok, (r, rm)
    _assert_layout(new, state, s_sh)
    assert all(met[k].device == mesh.devices.flat[0] for k in met)
    dp, mp = int(np.prod(dims[:-1])), dims[-1]
    assert len(spans) == dp * cfg.n_layers * _kinds(cfg) * (2 if cfg.remat else 1), spans
    assert all(s["mp"] == mp and s["partial_bytes"] == mp * (4 // dp) * 16 * cfg.d_model * 4
               for s in spans), spans


def test_each_block_gradient_covers_its_slice_on_its_device():
    """On the tensor-parallel route a split leaf's gradient comes as M
    boxes, model shard m's slice of its split dim on the row's m-th
    device, and together they are the unsharded gradient."""
    cfg, model, opt, state, mesh = _setup("qwen3-8b", (1, 4), ("data", "model"))
    batch = _batch(cfg)
    _, _, grads = steps.shard_value_and_grad(model, state["params"], batch, mesh,
                                             tensor_parallel=True)
    _, _, want, _ = steps._value_and_grad(model, state["params"], batch)
    want = tree_leaves(want)
    paths = ["/".join(p) for p in steps._leaf_paths(state["params"])]
    split = {"embed": 0, "lm_head": 1, "layers/attn/wq": 2, "layers/attn/wk": 2,
             "layers/attn/wv": 2, "layers/attn/wo": 1, "layers/mlp/w_gate": 2,
             "layers/mlp/w_up": 2, "layers/mlp/w_down": 1}
    row = list(steps._shard_grid(mesh)[0][0])
    by_leaf = {}
    for k, box, g in grads:
        by_leaf.setdefault(paths[k], []).append((box, g))
    for path, got in by_leaf.items():
        w = want[paths.index(path)]
        if path not in split:
            assert len(got) == 1 and got[0][0] == steps._full(w.shape), path
            continue
        ax, n = split[path], w.shape[split[path]] // 4
        assert len(got) == 4, path
        for m, (box, g) in enumerate(got):
            assert box[ax] == (m * n, (m + 1) * n) and g.device == torch.device(row[m])
        whole = torch.cat([g for _, g in got], dim=ax)
        err = float((whole - w).abs().max()) / float(w.abs().max())
        assert err <= 1e-5, (path, err)


def test_a_dropped_model_shard_partial_fails_the_tolerances(monkeypatch):
    """The row-parallel sums against a planted fault: the same steps with
    model shard 1's partial left out of every sum fail."""
    for arch, kw, dims in (("qwen3-8b", {}, (2, 4)), ("kimi-k2-1t-a32b", {"remat": True}, (2, 2))):
        cfg, model, opt, state, mesh = _setup(arch, dims, ("data", "model"), **kw)
        batch = _batch(cfg)
        want, want_m = _unsharded(model, opt, state, batch, mesh)
        new, met, spans = _step(model, opt, state, batch, mesh, cfg)
        ok, r, rm = _within(shd.gather(new), want, met, want_m)
        assert ok, (arch, r, rm)
        with monkeypatch.context() as mp:
            drop = _DropPartial(mp)
            new, met, _ = _step(model, opt, state, batch, mesh, cfg)
        assert drop.calls == len(spans)
        ok, r, rm = _within(shd.gather(new), want, met, want_m)
        assert not ok and rm["grad_norm"] > 100 * METRIC_RTOL and r["params"] > 10 * PARAM_RTOL, (
            arch, r, rm)


# ---------------------------------------------------------------- the embedding


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_vocab_parallel_embedding_is_the_lookup_bit_for_bit(mp, dtype):
    cfg, model, opt, state, mesh = _setup("stablelm-1.6b", (1, mp), ("data", "model"))
    embed = state["params"]["embed"].to(dtype)
    tokens = torch.as_tensor(np.random.RandomState(mp).randint(0, cfg.vocab_size, (4, 16)))
    tokens[0, :4] = torch.tensor([0, cfg.vocab_size - 1, cfg.vocab_size // mp,
                                  cfg.vocab_size // mp - 1])
    live, _ = _live(cfg, dict(state, params=dict(state["params"], embed=embed)), mesh,
                    _batch(cfg))
    assert isinstance(live["embed"], steps._Blocks) and len(live["embed"].blocks) == mp
    got = tT._embed_rows(live["embed"], tokens)
    assert _bits_equal(got, embed[tokens])


def test_the_vocab_parallel_loss_is_the_chunked_loss():
    """``lm_loss`` with a split head (and embedding) against the whole
    one: the log-partition from the shards' maxima and sums, the gold
    logit from the owning shard; loss and gradients within f32 rounding,
    over a loss chunk that pads the tail."""
    cfg, model, opt, state, mesh = _setup("stablelm-1.6b", (1, 4), ("data", "model"),
                                          loss_chunk=6)
    batch = _batch(cfg, S=16)
    live, lives = _live(cfg, state, mesh, batch)
    assert set(_split(live)) >= {"embed", "lm_head"}
    whole = {k: v for k, v in live.items() if k != "layers"}
    whole["layers"] = state["params"]["layers"]
    split = dict(whole, embed=live["embed"], lm_head=live["lm_head"])
    loss, _ = tT.lm_loss(split, batch, cfg)
    ref_params = {k: (v.detach().requires_grad_(True) if isinstance(v, torch.Tensor) else v)
                  for k, v in state["params"].items()}
    want, _ = tT.lm_loss(ref_params, batch, cfg)
    assert abs(float(loss.detach()) - float(want.detach())) <= 1e-6 * abs(float(want.detach()))
    g = torch.autograd.grad(loss, live["lm_head"].blocks)
    gw = torch.autograd.grad(want, ref_params["lm_head"])[0]
    err = float((torch.cat(g, dim=1) - gw).abs().max()) / float(gw.abs().max())
    assert err <= 1e-5, err


# ---------------------------------------------------------------- attention cases


@pytest.mark.parametrize("dims,heads", [((1, 4), (4, 2, 64)), ((2, 4), (4, 2, 64)),
                                        ((1, 2), (12, 3, 32))],
                         ids=["1x4", "2x4", "1x2_12q_3kv"])
def test_gqa_kv_heads_that_do_not_divide_keep_wk_wv_whole(dims, heads):
    """qwen3 reduced with kv heads that do not divide the model shards (2
    over 4; 3 over 2, with 12 query heads): the spec keeps ``wk``/``wv``
    whole, each shard computes K and V from the whole leaf and keeps the
    kv heads its query heads read (over 2 shards of 6 query heads, groups
    of 4 cut across a shard, so one kv head a query head); the whole
    leaf's gradient is the sum over the shards (autograd's, through the
    copies)."""
    cfg, model, opt, state, mesh = _setup("qwen3-8b", dims, ("data", "model"),
                                          n_heads=heads[0], n_kv_heads=heads[1],
                                          head_dim=heads[2])
    batch = _batch(cfg)
    live, _ = _live(cfg, state, mesh, batch)
    split = _split(live)
    assert "layers/attn/wq" in split and "layers/attn/wo" in split
    assert not {"layers/attn/wk", "layers/attn/wv"} & set(split)
    new, met, spans = _step(model, opt, state, batch, mesh, cfg)
    want, want_m = _unsharded(model, opt, state, batch, mesh)
    ok, r, rm = _within(shd.gather(new), want, met, want_m)
    assert ok, (r, rm)
    assert len(spans) == dims[0] * cfg.n_layers * 2
    _, _, grads = steps.shard_value_and_grad(model, state["params"], batch,
                                             steps._row_mesh(mesh, ("data",), 0) if dims[0] > 1
                                             else mesh, tensor_parallel=True)
    paths = ["/".join(p) for p in steps._leaf_paths(state["params"])]
    wk = [(box, g) for k, box, g in grads if paths[k] == "layers/attn/wk"]
    assert len(wk) == 1 and wk[0][0] == steps._full(state["params"]["layers"]["attn"]["wk"].shape)


def test_heads_that_do_not_divide_read_the_attention_whole():
    """6 heads over 4 model shards: ``wq``'s flat dim (6 x 64) divides and
    the spec splits it, but the step never splits a head, so the
    attention reads whole (the plain block) while the MLP splits."""
    cfg, model, opt, state, mesh = _setup("qwen3-8b", (1, 4), ("data", "model"), n_heads=6,
                                          n_kv_heads=2)
    batch = _batch(cfg)
    s_sh, _ = _shardings(cfg, state, batch, mesh)
    assert shd.model_dim(s_sh["params"]["layers"]["attn"]["wq"].spec, 3) == 2
    split = _split(_live(cfg, state, mesh, batch)[0])
    assert not [p for p in split if "/attn/" in p] and "layers/mlp/w_down" in split
    new, met, spans = _step(model, opt, state, batch, mesh, cfg)
    want, want_m = _unsharded(model, opt, state, batch, mesh)
    ok, r, rm = _within(shd.gather(new), want, met, want_m)
    assert ok, (r, rm)
    assert [s["kind"] for s in spans] == ["mlp"] * cfg.n_layers


def test_a_block_leaf_the_branch_cannot_take_raises():
    """No fallback: heads that do not divide the blocks, a block on
    another device than its shard's, half the attention split, or a
    whole cache tensor where the tensor-parallel decode reads one a model
    shard, raise."""
    cfg, model, opt, state, mesh = _setup("qwen3-8b", (1, 4), ("data", "model"))
    batch = _batch(cfg)
    live, _ = _live(cfg, state, mesh, batch)
    layer = tT._unstack(live["layers"], cfg.n_layers)[0]
    x = torch.zeros(4, 16, cfg.d_model)
    pos = tT._positions(cfg, 4, 16, "cpu")
    with pytest.raises(ValueError, match="heads do not divide"):
        tL.attention_block(layer["attn"], x, dataclasses.replace(cfg, n_heads=6), pos)
    moved = steps._Blocks(layer["attn"]["wo"].blocks[:3] + [torch.empty(0, device="meta")],
                          -2, 0)
    with pytest.raises(ValueError, match="not a block leaf"):
        tL.attention_block(dict(layer["attn"], wo=moved), x, cfg, pos)
    whole_wo = torch.cat(layer["attn"]["wo"].blocks, dim=0)
    with pytest.raises(ValueError, match="split together"):
        tL.attention_block(dict(layer["attn"], wo=whole_wo), x, cfg, pos)
    with pytest.raises(ValueError, match="not a block leaf"):
        tL.mlp_block(dict(layer["mlp"], w_down=torch.cat(layer["mlp"]["w_down"].blocks)), x)
    with pytest.raises(ValueError, match="not a list of one tensor a model shard"):
        model.decode(live, model.init_cache(4, 8, "cpu"),
                     {"tokens": torch.zeros(4, 1, dtype=torch.int32),
                      "pos": torch.zeros(4, dtype=torch.int32)})


# ---------------------------------------------------------------- families


def _dense_residual_col_specs(s_sh, mesh):
    """The shardings with arctic's dense residual (and its moments) split
    Megatron-style, the columns of ``w_gate``/``w_up`` and the rows of
    ``w_down``, where the reference's rule gives its layer axis to
    ``model``."""
    def split(tree):
        dense = dict(tree["layers"]["moe"]["dense_mlp"])
        for n in ("w_gate", "w_up"):
            dense[n] = shd.NamedSharding(mesh, shd.P(None, None, "model"))
        dense["w_down"] = shd.NamedSharding(mesh, shd.P(None, "model", None))
        moe = dict(tree["layers"]["moe"], dense_mlp=dense)
        return dict(tree, layers=dict(tree["layers"], moe=moe))

    return dict(s_sh, params=split(s_sh["params"]),
                opt={k: split(v) for k, v in s_sh["opt"].items()})


@pytest.mark.parametrize("experts", [4, 3], ids=["expert_parallel", "local"])
def test_arctics_dense_residual(experts):
    """Under the reference's specs the dense residual's layer axis goes to
    ``model`` (the expert rule takes it), so the step reads it whole; with
    its columns split, ``mlp_block``'s branch runs it on the MoE's
    expert-parallel branch (4 experts over 2 shards) and on its local
    path (3 experts: the batch runs as one shard)."""
    cfg, model, opt, state, mesh = _setup("arctic-480b", (2, 2), ("data", "model"),
                                          n_experts=experts)
    batch = _batch(cfg)
    want, want_m = _unsharded(model, opt, state, batch, mesh)
    s_sh, _ = _shardings(cfg, state, batch, mesh)
    split = _split(_live(cfg, state, mesh, batch)[0])
    assert not [p for p in split if "dense_mlp" in p]
    for specs, kinds in ((s_sh, {"attn"}), (_dense_residual_col_specs(s_sh, mesh),
                                            {"attn", "mlp"})):
        new, met, spans = _step(model, opt, state, batch, mesh, cfg, s_sh=specs)
        ok, r, rm = _within(shd.gather(new), want, met, want_m)
        assert ok, (experts, kinds, r, rm)
        assert {s["kind"] for s in spans} == kinds
        _assert_layout(new, state, specs)


@pytest.mark.parametrize("dims", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_vlm_with_patches(dims):
    """qwen2-vl reduced (q/k/v biases, 2 kv heads, M-RoPE) with 4 patch
    embeddings a row: ``vis_proj`` whole, the rest split; on (1, 4) the 2
    kv heads stay whole (the GQA rule)."""
    cfg, model, opt, state, mesh = _setup("qwen2-vl-2b", dims, ("data", "model"), attn_chunk=8)
    batch = _batch(cfg, B=4, S=12)
    new, met, spans = _step(model, opt, state, batch, mesh, cfg)
    want, want_m = _unsharded(model, opt, state, batch, mesh)
    got = shd.gather(new)
    bk = (got["params"]["layers"]["attn"]["bk"] - want["params"]["layers"]["attn"]["bk"]).abs()
    assert float(bk.max()) <= BK_ABS, float(bk.max())
    for tree in (got, want):
        tree["params"]["layers"]["attn"]["bk"] = torch.zeros(())
    ok, r, rm = _within(got, want, met, want_m)
    assert ok, (r, rm)
    assert len(spans) == dims[0] * cfg.n_layers * 2
    assert "vis_proj" not in _split(_live(cfg, state, mesh, batch)[0])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b", "whisper-tiny"],
                         ids=["ssm", "hybrid", "audio"])
def test_other_families_read_every_leaf_whole(arch):
    """ssm, hybrid and audio on a mesh whose model axis has size 1: the
    tensor-parallel route reads every leaf whole, so it is the gather
    route bit for bit (their split over a model axis of 2 or more:
    ``tests/test_torch_tensor_parallel_ssm.py``)."""
    cfg, model, opt, state, mesh = _setup(arch, (2, 1), ("data", "model"), attn_chunk=8)
    batch = _batch(cfg, B=4, S=12)
    assert not _split(_live(cfg, state, mesh, batch)[0])
    new, met, spans = _step(model, opt, state, batch, mesh, cfg)
    gather, gather_m, _ = _step(model, opt, state, batch, mesh, cfg, tp=False)
    assert not spans
    for a, b in zip(tree_leaves(shd.gather(new)), tree_leaves(shd.gather(gather))):
        assert _bits_equal(a, b)
    assert all(_bits_equal(met[k], gather_m[k]) for k in gather_m)


# ---------------------------------------------------------------- the reference


def test_equals_the_references_sharded_step(ref_dir, monkeypatch):
    """qwen3-8b reduced, the reference's jitted step on a (2, 4) mesh of 8
    host devices against the port's tensor-parallel step on the same
    numpy params and batch; the planted fault fails."""
    z = np.load(ref_dir / "qwen3.npz")
    params = convert.params_from_numpy(_nest({k[2:]: z[k] for k in z.files if k[:2] == "p/"}),
                                       "cpu")
    cfg, model, opt, state, mesh = _setup("qwen3-8b", (2, 4), ("data", "model"), adamw(LR),
                                          params=params)
    batch = {"tokens": torch.as_tensor(z["tokens"])}
    ref = [z[f"s/{i:04d}"] for i in range(sum(k[:2] == "s/" for k in z.files))]
    structure = tree_flatten(steps.train_state_shapes(model, opt))[1]
    want = tree_unflatten(structure, [torch.from_numpy(a) for a in ref])
    want_m = {k[2:]: torch.as_tensor(z[k]) for k in z.files if k[:2] == "m/"}
    new, met, spans = _step(model, opt, state, batch, mesh, cfg)
    ok, r, rm = _within(shd.gather(new), want, met, want_m)
    assert ok, (r, rm)
    assert len(spans) == 2 * cfg.n_layers * 2
    # the reference's own test: loss within 1e-2 absolute, params 5e-2
    got = shd.gather(new)
    assert abs(float(met["loss"]) - float(want_m["loss"])) < 1e-2
    assert max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(got["params"]), tree_leaves(want["params"]))) < 5e-2
    with monkeypatch.context() as mp:
        _DropPartial(mp)
        new, met, _ = _step(model, opt, state, batch, mesh, cfg)
    ok, r, rm = _within(shd.gather(new), want, met, want_m)
    assert not ok and rm["grad_norm"] > 100 * METRIC_RTOL, (r, rm)
