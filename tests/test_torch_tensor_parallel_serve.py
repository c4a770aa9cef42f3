"""The sharded prefill and decode (``launch.steps.make_sharded_prefill_step``
and ``make_sharded_decode_step``) on the CPU: meshes of repeated ``"cpu"``
devices, one process driving every shard, the cache a tree of ``Placed``
leaves cut by ``cache_spec``, as ``tests/test_torch_tensor_parallel.py``
runs the train step's routes.

What they must equal:

- on a (1, 1) mesh, ``make_prefill_step`` and ``make_decode_step`` bit for
  bit (logits and cache);
- on a mesh without a model axis, each other bit for bit (the routes);
- on any other mesh, the unsharded steps run under ``use_mesh`` of the
  same mesh (so an MoE takes the same branch), within the bounds below;
- the reference's own sharded steps, ``jax.jit(make_prefill_step,
  in_shardings=...)`` and ``jax.jit(make_decode_step, in_shardings=...,
  donate_argnums=(1,))`` on a (2, 4) mesh of 8 forced host devices
  (qwen3-8b reduced), within the same bounds.

Each run is a prefill of B x 16 tokens, ``grow_cache`` (of the placed
cache: ``steps.grow_placed_cache``) by 4 slots and 4
teacher-forced decode steps (the tokens drawn from a seed, so that a
near-tie cannot cascade). Bounds (f32), with the readings over every case
here and the planted fault's (model shard 1's partial dropped from every
row-parallel sum, ``layers._row_sum``):

- logits, each step's ``max |a - b| / max |b|``: ``LOGIT_RTOL`` 1e-5;
  readings up to 1.4e-6 (the reference's steps: 1.2e-6, as far as the
  port's unsharded steps read from them), the fault 0.67 and more;
- the cache's k and v after the last step, the same measure:
  ``CACHE_RTOL`` 1e-5; readings up to 1.2e-6 (the reference's: 1.0e-6),
  the fault 0.60 and more; ``pos`` bit for bit.

The row-parallel sums add f32 partials in another order than one product
over the whole width; a data shard's products over fewer rows block their
sums their own way too (the gather route of ssm, hybrid and audio reads
up to 1.4e-6 with no model split at all).
"""

import math

import numpy as np
import pytest
import torch

from _multidevice import run_multidevice
from repro_torch import convert, obs
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import layers as tL
from repro_torch.models.registry import build_model
from repro_torch.util import use_mesh
from test_torch_sharded_train import _bits_equal, _cfg, _mesh, _nest
from test_torch_tensor_parallel import _DropPartial

LOGIT_RTOL = 1e-5
CACHE_RTOL = 1e-5
B, S, GEN = 4, 16, 4

TP_MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
             ((2, 2, 2), ("pod", "data", "model"))]
TP_IDS = ["2x2", "1x4", "2x2x2"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (as ``tests/test_torch_sharded_train.py``: the
    steps' many small ops otherwise wait on the thread pool's barriers
    beside the suite's other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- helpers


def _model(arch, **kw):
    cfg = _cfg(arch, **kw)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


def _inputs(cfg, b=B, seed=0):
    """A prompt batch (with patches for vlm, frames for audio) and the
    teacher-forced decode tokens (b, GEN)."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, S)),
                                       dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = torch.as_tensor(rng.randn(b, 4, cfg.frontend_dim).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(
            rng.randn(b, cfg.encoder_seq, cfg.frontend_dim).astype(np.float32))
    return batch, rng.randint(0, cfg.vocab_size, (b, GEN))


def _step_batch(toks, g):
    b = toks.shape[0]
    return {"tokens": torch.as_tensor(toks[:, g:g + 1], dtype=torch.int32),
            "pos": torch.full((b,), S + g, dtype=torch.int32)}


def _cache_len(cfg):
    return S + GEN + (4 if cfg.family == "vlm" else 0)


def _unsharded(model, params, batch, toks, mesh):
    """The unsharded prefill and decode steps under ``use_mesh(mesh)``:
    ([logits], cache)."""
    with use_mesh(mesh):
        lg, cache = steps.make_prefill_step(model)(params, batch)
        cache = model.grow_cache(cache, _cache_len(model.cfg))
        out = [lg]
        for g in range(toks.shape[1]):
            lg, cache = steps.make_decode_step(model)(params, cache, _step_batch(toks, g))
            out.append(lg)
    return out, cache


def _sharded(model, params, batch, toks, mesh, tp=True, each_step=None):
    """The sharded prefill, ``grow_placed_cache`` and decode steps: ([logits],
    placed cache, {span name: [args]} of the prefill and of the decode).
    ``each_step(cache)`` runs after each decode step."""
    cfg = model.cfg
    p_sh = shd.to_named(shd.tree_param_specs(params, mesh, n_kv_heads=cfg.n_kv_heads), mesh)
    b_sh = shd.to_named(shd.batch_spec(batch, mesh), mesh)
    with obs.enabled() as tracer:
        lg, cache = steps.make_sharded_prefill_step(model, p_sh, b_sh, tensor_parallel=tp)(
            params, batch)
    pre = tracer.events
    cache = steps.grow_placed_cache(model, cache, _cache_len(cfg))
    c_sh = {k: v.sharding for k, v in cache.items()}
    out = [lg]
    with obs.enabled() as tracer:
        for g in range(toks.shape[1]):
            sb = _step_batch(toks, g)
            s_sh = shd.to_named(shd.batch_spec(sb, mesh), mesh)
            lg, new = steps.make_sharded_decode_step(model, p_sh, c_sh, s_sh,
                                                     tensor_parallel=tp)(params, cache, sb)
            assert new is cache
            out.append(lg)
            if each_step is not None:
                each_step(cache)
    spans = {}
    for tag, events in (("prefill", pre), ("decode", tracer.events)):
        for e in events:
            spans.setdefault((tag, e.name), []).append(e.args)
    return out, cache, spans


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


def _readings(got, cache, want, wcache):
    """(worst logit reading over the steps, worst k/v reading, pos equal)."""
    lg = max(_rel(a, b) for a, b in zip(got, want))
    kv = max(_rel(shd.gather(cache[n]), wcache[n]) for n in ("k", "v"))
    return lg, kv, _bits_equal(shd.gather(cache["pos"]), wcache["pos"])


def _assert_cut_by_cache_spec(cache, mesh):
    shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in cache.items()}
    specs = shd.cache_spec(shapes, mesh)
    for name, leaf in cache.items():
        assert isinstance(leaf, shd.Placed) and leaf.sharding.spec == specs[name], name
        assert leaf.sharding.mesh is mesh
        for idx in np.ndindex(leaf.pieces.shape):
            want = tuple(b - a for a, b in leaf.bounds(idx))
            assert tuple(leaf.pieces[idx].shape) == want, (name, idx)


# ---------------------------------------------------------------- bit for bit


@pytest.mark.parametrize("arch,kw", [("qwen3-8b", {}), ("falcon-mamba-7b", {}),
                                     ("whisper-tiny", {"attn_chunk": 8})],
                         ids=["qwen3", "ssm", "audio"])
def test_one_by_one_is_the_unsharded_steps_bit_for_bit(arch, kw):
    cfg, model, params = _model(arch, **kw)
    batch, toks = _inputs(cfg)
    mesh = _mesh((1, 1), ("data", "model"))
    want, wcache = _unsharded(model, params, batch, toks, mesh)
    for tp in (False, True):
        got, cache, _ = _sharded(model, params, batch, toks, mesh, tp=tp)
        assert all(_bits_equal(a, b) for a, b in zip(got, want)), tp
        for name in wcache:
            assert _bits_equal(shd.gather(cache[name]), wcache[name]), (tp, name)


@pytest.mark.parametrize("arch", ["qwen3-8b", "kimi-k2-1t-a32b"], ids=["qwen3", "kimi"])
def test_without_a_model_axis_the_routes_are_bit_for_bit(arch):
    cfg, model, params = _model(arch)
    batch, toks = _inputs(cfg)
    mesh = _mesh((2, 1), ("data", "model"))
    got, cache, spans = _sharded(model, params, batch, toks, mesh, tp=True)
    want, wcache, _ = _sharded(model, params, batch, toks, mesh, tp=False)
    assert not [k for k in spans if k[1] == "tensor_parallel"]
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    for name in wcache:
        for p, q in zip(cache[name].pieces.flat, wcache[name].pieces.flat):
            assert _bits_equal(p, q), name


# ---------------------------------------------------------------- against the unsharded steps


@pytest.mark.parametrize("dims,axes", TP_MESHES, ids=TP_IDS)
def test_tensor_parallel_serve_matches_the_unsharded_steps(dims, axes):
    """qwen3 reduced with GQA (8 query heads over 4 kv heads) and qk-norm:
    the prefill and 4 decode steps within the bounds; the attention takes
    one ``tensor_parallel`` span a layer a data shard in the prefill
    (``attn``) and in each decode step (``attn_decode``), each model
    shard's cache its own piece (no ``cache_copy``); the cache is cut by
    ``cache_spec``."""
    cfg, model, params = _model("qwen3-8b", n_heads=8, n_kv_heads=4)
    batch, toks = _inputs(cfg)
    mesh = _mesh(dims, axes)
    want, wcache = _unsharded(model, params, batch, toks, mesh)
    got, cache, spans = _sharded(model, params, batch, toks, mesh)
    lg, kv, pos = _readings(got, cache, want, wcache)
    assert lg <= LOGIT_RTOL and kv <= CACHE_RTOL and pos, (lg, kv, pos)
    _assert_cut_by_cache_spec(cache, mesh)
    dp, mp = math.prod(dims[:-1]), dims[-1]
    kinds = [s["kind"] for s in spans[("prefill", "tensor_parallel")]]
    assert kinds.count("attn") == kinds.count("mlp") == dp * cfg.n_layers
    kinds = [s["kind"] for s in spans[("decode", "tensor_parallel")]]
    assert kinds.count("attn_decode") == GEN * dp * cfg.n_layers
    assert all(s["mp"] == mp for s in spans[("decode", "tensor_parallel")])
    assert ("decode", "cache_copy") not in spans
    assert got[0].device == mesh.devices.flat[0] and got[0].shape == (B, cfg.vocab_size)


def test_a_dropped_model_shard_partial_fails_the_bounds(monkeypatch):
    """The bounds against the planted fault: model shard 1's partial left
    out of every row-parallel sum of the prefill and the decode steps."""
    cfg, model, params = _model("qwen3-8b")
    batch, toks = _inputs(cfg)
    mesh = _mesh((2, 2), ("data", "model"))
    want, wcache = _unsharded(model, params, batch, toks, mesh)
    with monkeypatch.context() as mp:
        drop = _DropPartial(mp)
        got, cache, _ = _sharded(model, params, batch, toks, mesh)
    assert drop.calls == (1 + GEN) * 2 * cfg.n_layers * 2
    lg, kv, _ = _readings(got, cache, want, wcache)
    assert lg > 1000 * LOGIT_RTOL and kv > 1000 * CACHE_RTOL, (lg, kv)
    # the prefill alone already fails
    assert _rel(got[0], want[0]) > 1000 * LOGIT_RTOL


@pytest.mark.parametrize("dims,heads", [((1, 4), (4, 2)), ((1, 2), (12, 3))],
                         ids=["1x4_4q_2kv", "1x2_12q_3kv"])
def test_kv_heads_that_do_not_divide_replicate_the_cache(dims, heads):
    """kv heads that do not divide the model shards (2 over 4; 3 over 2,
    where a shard's 6 query heads cut across groups of 4, so it reads one
    kv head a query head): ``wk``/``wv`` whole, ``cache_spec`` leaves the
    kv heads whole, so every model shard's piece holds every kv head,
    computed by that shard; every replica is equal after the prefill and
    after each decode step."""
    cfg, model, params = _model("qwen3-8b", n_heads=heads[0], n_kv_heads=heads[1], head_dim=32)
    batch, toks = _inputs(cfg)
    mesh = _mesh(dims, ("data", "model"))

    def replicas_equal(cache):
        for name in ("k", "v", "pos"):
            first = cache[name].pieces.flat[0]
            assert all(_bits_equal(p, first) for p in cache[name].pieces.flat), name

    want, wcache = _unsharded(model, params, batch, toks, mesh)
    got, cache, spans = _sharded(model, params, batch, toks, mesh, each_step=replicas_equal)
    assert cache["k"].sharding.spec[-2] is None
    assert cache["k"].pieces[0, 0].shape[-2] == heads[1]
    replicas_equal(cache)
    lg, kv, pos = _readings(got, cache, want, wcache)
    assert lg <= LOGIT_RTOL and kv <= CACHE_RTOL and pos, (lg, kv, pos)
    assert ("decode", "cache_copy") not in spans


@pytest.mark.parametrize("dims", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_vlm_with_patches_and_biases(dims):
    """qwen2-vl reduced (q/k/v biases, M-RoPE, 4 patch embeddings a row; 2
    kv heads: replicated on (1, 4), split on (2, 2))."""
    cfg, model, params = _model("qwen2-vl-2b", attn_chunk=8)
    for name in ("bq", "bk", "bv"):  # the biases non-zero, so a wrong slice shows
        leaf = params["layers"]["attn"][name]
        leaf.copy_(torch.as_tensor(np.random.RandomState(7).randn(*leaf.shape) * 0.1))
    batch, toks = _inputs(cfg)
    mesh = _mesh(dims, ("data", "model"))
    want, wcache = _unsharded(model, params, batch, toks, mesh)
    got, cache, spans = _sharded(model, params, batch, toks, mesh)
    lg, kv, pos = _readings(got, cache, want, wcache)
    assert lg <= LOGIT_RTOL and kv <= CACHE_RTOL and pos, (lg, kv, pos)
    assert len(spans[("decode", "tensor_parallel")]) == GEN * dims[0] * cfg.n_layers * 2


def test_kimi_takes_the_expert_parallel_branch_in_prefill_and_the_local_path_in_decode():
    """kimi-k2 reduced, 2 rows on (2, 2): the prefill's 16 tokens a data
    shard take the MoE's expert-parallel branch (``moe_shard_map``) per
    data shard; a decode step's 2 tokens do not, so the batch runs as one
    shard under the whole mesh (the local path) and each unit reads its
    box of the data-split cache as a copy, written back after the step."""
    cfg, model, params = _model("kimi-k2-1t-a32b")
    batch, toks = _inputs(cfg, b=2)
    mesh = _mesh((2, 2), ("data", "model"))
    want, wcache = _unsharded(model, params, batch, toks, mesh)
    got, cache, spans = _sharded(model, params, batch, toks, mesh)
    lg, kv, pos = _readings(got, cache, want, wcache)
    assert lg <= LOGIT_RTOL and kv <= CACHE_RTOL and pos, (lg, kv, pos)
    moe = spans[("prefill", "moe_shard_map")]
    assert len(moe) == 2 * cfg.n_layers and all(s["tokens"] == S for s in moe)
    assert ("decode", "moe_shard_map") not in spans
    assert len(spans[("decode", "cache_copy")]) == GEN * 3 * 2


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b", "whisper-tiny"],
                         ids=["ssm", "hybrid", "audio"])
def test_other_families_serve_on_the_gather_route(arch):
    """ssm, hybrid and audio on the gather route read every leaf whole;
    their caches (the ssm state's channels over ``model``, ``enc_out`` cut
    too) are cut by ``cache_spec`` and stay within the bounds (their
    tensor-parallel route: ``tests/test_torch_tensor_parallel_ssm.py``)."""
    cfg, model, params = _model(arch, attn_chunk=8)
    batch, toks = _inputs(cfg)
    mesh = _mesh((2, 2), ("data", "model"))
    want, wcache = _unsharded(model, params, batch, toks, mesh)
    got, cache, spans = _sharded(model, params, batch, toks, mesh, tp=False)
    assert not [k for k in spans if k[1] == "tensor_parallel"]
    _assert_cut_by_cache_spec(cache, mesh)
    assert max(_rel(a, b) for a, b in zip(got, want)) <= LOGIT_RTOL
    for name in wcache:
        assert _rel(shd.gather(cache[name]), wcache[name]) <= CACHE_RTOL, name
    if arch == "falcon-mamba-7b":
        assert shd.model_dim(cache["h"].sharding.spec, 4) == 2
    if arch == "whisper-tiny":
        assert any(cache["enc_out"].sharding.spec)


def test_a_ring_split_over_data_is_read_whole_and_its_slot_written_back():
    """B 1 on (2, 2): ``batch_spec`` leaves the batch whole and
    ``cache_spec`` puts ``data`` on the cache's W dim, so each model shard
    reads its kv heads of every slot as a copy (span ``cache_copy``), and
    the token's slot goes back into the one piece that holds it."""
    cfg, model, params = _model("qwen3-8b")
    batch, toks = _inputs(cfg, b=1)
    mesh = _mesh((2, 2), ("data", "model"))
    want, wcache = _unsharded(model, params, batch, toks, mesh)
    got, cache, spans = _sharded(model, params, batch, toks, mesh)
    assert cache["k"].sharding.spec == shd.P(None, None, "data", "model", None)
    lg, kv, pos = _readings(got, cache, want, wcache)
    assert lg <= LOGIT_RTOL and kv <= CACHE_RTOL and pos, (lg, kv, pos)
    copies = spans[("decode", "cache_copy")]
    assert len(copies) == GEN * 3 * 2 and {c["leaf"] for c in copies} == {"k", "v", "pos"}
    # the next step's slot, 20 % 20 = slot 0, lies in data row 0's pieces only
    before = [p.clone() for p in cache["k"].pieces.flat]
    p_sh = shd.to_named(shd.tree_param_specs(params, mesh, n_kv_heads=cfg.n_kv_heads), mesh)
    sb = {"tokens": torch.zeros((1, 1), dtype=torch.int32),
          "pos": torch.full((1,), _cache_len(cfg), dtype=torch.int32)}
    steps.make_sharded_decode_step(
        model, p_sh, {k: v.sharding for k, v in cache.items()},
        shd.to_named(shd.batch_spec(sb, mesh), mesh), tensor_parallel=True)(params, cache, sb)
    changed = [not _bits_equal(p, q) for p, q in zip(cache["k"].pieces.flat, before)]
    assert changed == [True, True, False, False]
    assert _bits_equal(cache["k"].pieces[1, 0], before[2])


# ---------------------------------------------------------------- the placed cache


def test_a_decode_step_writes_into_the_same_piece_tensors():
    cfg, model, params = _model("qwen3-8b")
    batch, toks = _inputs(cfg)
    mesh = _mesh((2, 2), ("data", "model"))
    ptrs = {}

    def same(cache):
        now = {(n, i): (p, p.data_ptr()) for n in cache for i, p in enumerate(cache[n].pieces.flat)}
        if ptrs:
            assert all(now[k][0] is ptrs[k][0] and now[k][1] == ptrs[k][1] for k in now)
        ptrs.update(now)

    _sharded(model, params, batch, toks, mesh, each_step=same)
    assert len(ptrs) == 3 * 4


@pytest.mark.parametrize("b", [4, 1], ids=["rows_split", "ring_split"])
def test_grow_cache_of_a_placed_cache(b):
    """Pieces grow on their devices where ``cache_spec`` of the grown
    shapes keeps the spec and the grown dim whole (B 4: the batch over
    ``data``); a ring split over ``data`` (B 1) is put together, grown and
    placed again. Either way it is the grown whole cache bit for bit."""
    cfg, model, params = _model("qwen3-8b")
    batch, _ = _inputs(cfg, b=b)
    mesh = _mesh((2, 2), ("data", "model"))
    p_sh = shd.to_named(shd.tree_param_specs(params, mesh, n_kv_heads=cfg.n_kv_heads), mesh)
    b_sh = shd.to_named(shd.batch_spec(batch, mesh), mesh)
    _, cache = steps.make_sharded_prefill_step(model, p_sh, b_sh, tensor_parallel=True)(
        params, batch)
    whole = model.grow_cache(shd.gather(cache), 22)
    grown = steps.grow_placed_cache(model, cache, 22)
    _assert_cut_by_cache_spec(grown, mesh)
    for name in whole:
        assert _bits_equal(shd.gather(grown[name]), whole[name]), name
        assert grown[name].sharding.spec == cache[name].sharding.spec
    assert steps.grow_placed_cache(model, grown, 10)["k"] is grown["k"]


# ---------------------------------------------------------------- what raises


def test_a_cache_or_block_leaf_the_branch_cannot_take_raises():
    """No fallback: half the attention split, a model shard's cache on
    another device, or a plain tensor where the branch wants one a model
    shard, raise; so does a piece on another device than its mesh index's."""
    cfg, model, params = _model("qwen3-8b")
    mesh = _mesh((1, 4), ("data", "model"))
    p_sh = shd.to_named(shd.tree_param_specs(params, mesh, n_kv_heads=cfg.n_kv_heads), mesh)
    live, _ = steps._shard_live(steps._placed(params, p_sh), mesh, cfg, grad=False)
    assert not any(t.requires_grad for t in tree_leaves(live) if isinstance(t, torch.Tensor))
    layer = steps._Blocks.unbind(live["layers"]["attn"]["wq"])[0]
    attn = {k: (steps._Blocks.unbind(v)[0] if isinstance(v, steps._Blocks) else v[0])
            for k, v in live["layers"]["attn"].items()}
    assert isinstance(layer, steps._Blocks)
    x = torch.zeros(2, 1, cfg.d_model)
    pos = torch.zeros(2, dtype=torch.long)
    Dh, KVl = cfg.resolved_head_dim(), cfg.n_kv_heads // 4
    cache = {"k": [torch.zeros(2, 8, KVl, Dh) for _ in range(4)],
             "v": [torch.zeros(2, 8, KVl, Dh) for _ in range(4)],
             "pos": [torch.full((2, 8), -1, dtype=torch.int32) for _ in range(4)]}
    out, _ = tL.attention_decode_block(attn, x, cfg, pos, cache)
    assert out.shape == x.shape and int(cache["pos"][3][0, 0]) == 0
    whole_wo = torch.cat(attn["wo"].blocks, dim=0)
    with pytest.raises(ValueError, match="split together"):
        tL.attention_decode_block(dict(attn, wo=whole_wo), x, cfg, pos, cache)
    moved = dict(cache, k=cache["k"][:3] + [torch.zeros(2, 8, KVl, Dh, device="meta")])
    with pytest.raises(ValueError, match="not a list of one tensor a model shard"):
        tL.attention_decode_block(attn, x, cfg, pos, moved)
    with pytest.raises(ValueError, match="not a list of one tensor a model shard"):
        tL.attention_decode_block(attn, x, cfg, pos, dict(cache, v=torch.cat(cache["v"], 2)))
    placed = shd.place(torch.zeros(4, 8), shd.NamedSharding(mesh, shd.P(None, "model")))
    pieces = placed.pieces.copy()
    pieces[0, 3] = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="piece"):
        shd.from_pieces(pieces, placed.sharding, (4, 8))
    assert shd.from_pieces(placed.pieces, placed.sharding, (4, 8)).shape == (4, 8)
    assert placed.piece(0, 2)[0] == ((0, 4), (4, 6))
    assert placed.piece(0, 2)[1] is placed.pieces[0, 2]


def test_grid_index_orders_pod_and_data_major_first():
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    assert shd.grid_index(mesh, 3, 1) == (1, 1, 1)
    assert shd.grid_index(mesh, 1, 0) == (0, 1, 0)
    with pytest.raises(ValueError, match="without a model axis"):
        shd.grid_index(_mesh((2,), ("data",)), 0, 1)


# ---------------------------------------------------------------- the dry run's decode case


@pytest.mark.parametrize("arch", ["deepseek-67b", "qwen1.5-110b"])
def test_dryrun_decode_with_kv_heads_that_do_not_divide_the_model_axis(arch):
    """decode_32k on the (16, 16) production mesh: 8 kv heads do not divide
    16, so ``cache_spec`` splits the cache over ``data`` only, ``wk``/``wv``
    stay whole and the tensor-parallel decode runs on meta (one
    ``attn_decode`` span a layer, every model shard's cache its own
    piece); the bytes a device are the specs'."""
    cfg = tdry.get_arch(arch)
    assert cfg.n_kv_heads == 8
    with obs.enabled() as tracer:
        rec = tdry.dryrun_one(arch, "decode_32k")
    assert rec["status"] == "ok", rec.get("error")
    spans = [e.args for e in tracer.events if e.name == "tensor_parallel"]
    assert [s["kind"] for s in spans].count("attn_decode") == cfg.n_layers
    assert all(s["mp"] == 16 for s in spans)
    assert not [e for e in tracer.events if e.name == "cache_copy"]
    model = build_model(cfg)
    cache = model.init_cache(128, 32_768, "meta")
    mesh = tdry.make_mesh((16, 16), ("data", "model"), devices=["meta"] * 256)
    specs = shd.cache_spec(cache, mesh)
    assert specs["k"] == specs["v"] == shd.P(None, "data", None, None, None)
    Dh = cfg.resolved_head_dim()
    per_dev = 2 * cfg.n_layers * (128 // 16) * 32_768 * 8 * Dh * 2 + cfg.n_layers * 8 * 32_768 * 4
    assert rec["bytes_cache"] == per_dev == shd.tree_spec_nbytes(cache, specs, mesh)
    params = model.init(None, "meta")
    wk = shd.param_spec(("layers", "attn", "wk"), tuple(params["layers"]["attn"]["wk"].shape),
                        mesh, n_kv_heads=8)
    assert shd.model_dim(wk, 3) is None


# ---------------------------------------------------------------- the reference

_REF_CHILD = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_arch
from repro.models import build_model
from repro.launch.steps import make_prefill_step, make_decode_step
from repro.launch import sharding as shd
from repro.launch.mesh import make_mesh
from repro.util import use_mesh

def key(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)

cfg = get_arch("qwen3-8b").reduced()
model = build_model(cfg)
params = model.init(jax.random.key(0))
rng = np.random.RandomState(0)
tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
toks = rng.randint(0, cfg.vocab_size, (B, GEN)).astype(np.int32)
mesh = make_mesh((2, 4), ("data", "model"))
sds = lambda t: jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), t)
p_sh = shd.to_named(shd.tree_param_specs(sds(params), mesh, n_kv_heads=cfg.n_kv_heads), mesh)
batch = {"tokens": jnp.asarray(tokens)}
out = {"tokens": tokens, "toks": toks}
with use_mesh(mesh):
    b_sh = shd.to_named(shd.batch_spec(sds(batch), mesh), mesh)
    prefill = jax.jit(make_prefill_step(model), in_shardings=(p_sh, b_sh))
    logits, cache = prefill(jax.device_put(params, p_sh), jax.device_put(batch, b_sh))
    out["l/0"] = np.asarray(logits)
    cache = model.grow_cache(cache, S + GEN)
    c_sh = shd.to_named(shd.cache_spec(sds(cache), mesh), mesh)
    for g in range(GEN):
        step = {"tokens": jnp.asarray(toks[:, g:g + 1]), "pos": jnp.full((B,), S + g, jnp.int32)}
        s_sh = shd.to_named(shd.batch_spec(sds(step), mesh), mesh)
        decode = jax.jit(make_decode_step(model), in_shardings=(p_sh, c_sh, s_sh),
                         donate_argnums=(1,))
        logits, cache = decode(jax.device_put(params, p_sh), jax.device_put(cache, c_sh),
                               jax.device_put(step, s_sh))
        out[f"l/{g + 1}"] = np.asarray(logits)
out.update({"c/" + k: np.asarray(v) for k, v in cache.items()})
out.update({"p/" + key(path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]})
np.savez(OUT + "/serve.npz", **out)
print("ok")
"""


def test_equals_the_references_sharded_prefill_and_decode(tmp_path, monkeypatch):
    """qwen3-8b reduced, the reference's jitted prefill and (donating)
    decode under in_shardings on a (2, 4) mesh of 8 host devices against
    the port's tensor-parallel steps on the same numpy params and tokens:
    each step's logits and the final k/v within the bounds, pos bit for
    bit; the planted fault fails."""
    run_multidevice(f"B, S, GEN = {B}, {S}, {GEN}\nOUT = {str(tmp_path)!r}\n" + _REF_CHILD)
    z = np.load(tmp_path / "serve.npz")
    params = convert.params_from_numpy(_nest({k[2:]: z[k] for k in z.files if k[:2] == "p/"}),
                                       "cpu")
    cfg, model, _ = _model("qwen3-8b")
    batch = {"tokens": torch.as_tensor(z["tokens"])}
    mesh = _mesh((2, 4), ("data", "model"))
    got, cache, spans = _sharded(model, params, batch, z["toks"], mesh)
    want = [torch.as_tensor(z[f"l/{g}"]) for g in range(GEN + 1)]
    wcache = {k: torch.as_tensor(z["c/" + k]) for k in ("k", "v", "pos")}
    lg, kv, pos = _readings(got, cache, want, wcache)
    assert lg <= LOGIT_RTOL and kv <= CACHE_RTOL and pos, (lg, kv, pos)
    assert len(spans[("decode", "tensor_parallel")]) == GEN * 2 * cfg.n_layers * 2
    with monkeypatch.context() as mp:
        _DropPartial(mp)
        got, cache, _ = _sharded(model, params, batch, z["toks"], mesh)
    lg, kv, _ = _readings(got, cache, want, wcache)
    assert lg > 1000 * LOGIT_RTOL and kv > 1000 * CACHE_RTOL, (lg, kv)
