"""The port's mesh-sharded data planes against the unsharded paths and the
JAX reference, on the CPU: the symbol-sharded OTA fold (barrier aggregate,
streaming accumulator, both round loops through
``FLConfig.mesh_data_shards``) and the row-sharded retrieval top-k.

Meshes are ``make_data_mesh(n, devices=["cpu"] * n)``: one process, n
shards on one device, the port's counterpart of the reference's forced
host devices (``make_data_mesh(n)`` itself spans n distinct cards). Each sharded result is held byte for byte (``tobytes``) to
the port's unsharded path, and to the reference on the same numpy inputs:

- the fold to the reference's oracles run op by op (``jax.disable_jit``),
  which is the arithmetic the port's kernels and plain versions do, and
  to the reference's jitted oracle within the suite's tolerance for it
  (rtol 1e-4, atol 1e-6 max|ref|: XLA's compiled reduction rounds the
  K-sum its own way, by up to about 2e-6 here);
- the top-k indices to the reference's jitted top-k byte for byte, and
  its scores byte for byte on integer grids (every dot exact), within the
  suite's 1e-6 elsewhere (the jitted dot sums in its own order).

The reference's own ``tests/test_mesh_dataplane.py`` holds its sharded
paths byte for byte to those jitted oracles. Inputs come from numpy seeds.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ota as jota
from repro.core import packing as jpacking
from repro.core import wire as jwire
from repro.kernels import ops as jops
from repro.retrieval.arena import ArenaStore as JArena
from repro.retrieval.engine import merge_candidates as jmerge
from repro_torch import convert, obs
from repro_torch.configs import FLConfig, get_arch
from repro_torch.core import ota as tota
from repro_torch.core import packing as tpacking
from repro_torch.core import wire as twire
from repro_torch.fl import FLServer, LatencyModel, StreamingFLServer
from repro_torch.kernels import ops as tops
from repro_torch.kernels import topk_similarity as ttk
from repro_torch.launch.mesh import DataMesh, make_data_mesh
from repro_torch.retrieval.arena import ArenaStore as TArena
from repro_torch.retrieval.engine import (
    RetrievalEngine,
    brute_force_topk,
    merge_candidates,
    normalize_rows,
)
from test_torch_fl import JaxDraws

SHARDS = (1, 2, 4, 8)
# the fold's shard counts: the reference's, and 3 and 5, whose chunks pad
# the 4,096-column layout (1,408 x 3 and 832 x 5 columns)
FOLD_SHARDS = (1, 2, 3, 4, 5, 8)


def _mesh(n):
    return make_data_mesh(n, devices=["cpu"] * n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bytes_equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------- the mesh


def test_make_data_mesh_shape_and_devices():
    m = _mesh(3)
    assert isinstance(m, DataMesh)
    assert m.shape == {"data": 3} and m.axis_names == ("data",)
    assert m.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        make_data_mesh(2, devices=["cpu"])


@pytest.mark.parametrize("n", [0, -1])
def test_make_data_mesh_rejects_fewer_than_one_shard(n):
    from repro.launch.mesh import make_data_mesh as jmake

    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        make_data_mesh(n, devices=[])
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        jmake(n)


@pytest.mark.parametrize("n", [1, 2])
def test_make_data_mesh_defaults_to_distinct_cards(n):
    """``devices=None`` spans the first n CUDA devices, one shard a card,
    and raises where fewer are visible, as the reference does past its
    visible device count."""
    from repro.launch.mesh import make_data_mesh as jmake

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n <= cards:
        assert make_data_mesh(n).devices == tuple(torch.device("cuda", i) for i in range(n))
    else:
        with pytest.raises(ValueError, match=f"needs {n} devices"):
            make_data_mesh(n)
    if n > len(jax.devices()):
        with pytest.raises(ValueError, match=f"needs {n} devices"):
            jmake(n)


def test_fl_server_mesh_argument_and_its_device():
    """``mesh=`` takes the place of the knob's mesh; a mesh that would
    gather the aggregate off the server's device is refused."""
    arch = get_arch("deepspeech2").with_(n_layers=1, d_model=32)
    cfg = FLConfig(n_clients=2, clients_per_round=2, seed=0)
    srv = FLServer(cfg, arch, device="cpu", shard_size=2, mesh=_mesh(3))
    assert srv.mesh.shape == {"data": 3}
    with pytest.raises(ValueError, match="the mesh gathers on meta"):
        FLServer(cfg, arch, device="cpu", mesh=make_data_mesh(2, devices=["meta", "cpu"]))


# ---------------------------------------------------------------- OTA fold

# the reference's cases (tests/test_mesh_dataplane.py): (bits, block, gains, seed)
OTA_CASES = {
    "int8": ([8] * 8, 64, None, 0),
    "int4": ([4] * 6, 64, None, 1),
    "int16": ([16] * 5, 64, None, 2),
    "f32": ([32] * 4, 0, None, 3),
    "mixed": ([4, 8, 16, 32, 8, 4, 16, 32], 64, None, 4),
    "per_row": ([8, 8, 4, 16], 0, None, 5),
    "gains": ([8] * 6, 64, [0.9, 0.0, 1.1, 0.7, 1.0, 0.85], 6),
    "ragged7": ([8] * 7, 64, None, 7),
    "ragged3": ([4, 8, 32], 64, None, 8),
}
TREE = {"a": (3000,), "b": (17, 5)}


@functools.lru_cache(maxsize=None)
def _ota_case(name):
    """Both packages' rows for one case, group-order fold weights and gains,
    the reference's fold of them (op by op and jitted) and the reference's
    aggregate report for the case's cohort weights."""
    bits, block, gains, seed = OTA_CASES[name]
    rng = np.random.RandomState(seed)
    lj = jpacking.make_layout({k: jnp.zeros(s, jnp.float32) for k, s in TREE.items()})
    lt = tpacking.make_layout({k: torch.zeros(s) for k, s in TREE.items()})
    draws = JaxDraws(3)
    rows_j, rows_t = [], []
    for j, b in enumerate(bits):
        full = np.zeros(lj.padded_size, np.float32)
        full[: lj.size] = rng.randn(lj.size).astype(np.float32)
        rows_j.append(jwire.encode_row(jnp.asarray(full), b, jnp.uint32(draws.sr_seed), j,
                                       block=block))
        rows_t.append(twire.encode_row(_t(full), b, draws.sr_seed, j, block=block))
    w = (rng.rand(len(bits)) + 0.5).astype(np.float32)
    g = None if gains is None else np.asarray(gains, np.float32)
    kinds, datas, scales, perm = jota._group_rows(rows_j)
    perm = np.asarray(perm)
    wg = rng.rand(len(bits)).astype(np.float32)  # group-order fold weights
    gg = None if g is None else g[perm]
    kw = dict(gains=None if gg is None else jnp.asarray(gg), use_kernel=False)
    with jax.disable_jit():
        eager = np.asarray(jota._fold_groups(None, kinds, datas, scales, jnp.asarray(wg), **kw))
    jitted = np.asarray(jota._fold_groups(None, kinds, datas, scales, jnp.asarray(wg), **kw))
    _, jinfo = jota.ota_aggregate_packed(
        jax.random.key(3), rows_j, bits, w, lj, jota.OTAConfig(),
        gains=None if g is None else jnp.asarray(g), use_kernel=False)
    return dict(lt=lt, rows_t=rows_t, w=w, g=g, wg=wg, gg=gg, kinds=kinds, eager=eager,
                jitted=jitted, jinfo=jinfo)


@pytest.mark.parametrize("shards", FOLD_SHARDS)
@pytest.mark.parametrize("case", sorted(OTA_CASES))
def test_sharded_fold_equals_the_reference_fold(case, shards):
    c = _ota_case(case)
    kinds, datas, scales, _ = tota._group_rows(c["rows_t"])
    assert kinds == c["kinds"]
    gg = None if c["gg"] is None else _t(c["gg"])
    got = tota._fold_groups(None, kinds, datas, scales, _t(c["wg"]), gains=gg,
                            mesh=_mesh(shards))
    want = tota._fold_groups(None, kinds, datas, scales, _t(c["wg"]), gains=gg)
    assert _bytes_equal(got, want)
    assert _bytes_equal(got, c["eager"])
    np.testing.assert_allclose(got.numpy(), c["jitted"], rtol=1e-4,
                               atol=1e-6 * np.abs(c["jitted"]).max())


@pytest.mark.parametrize("shards", FOLD_SHARDS)
@pytest.mark.parametrize("case", sorted(OTA_CASES))
def test_sharded_aggregate_equals_the_unsharded_aggregate(case, shards):
    """``ota_aggregate_packed(mesh=)`` with the reference's round draws:
    the update tree, the pre-noise aggregate and the report byte for byte
    the unsharded call's; participation and bytes the reference's."""
    c = _ota_case(case)
    bits = [r.bits for r in c["rows_t"]]
    g = None if c["g"] is None else _t(c["g"])
    cfg = tota.OTAConfig()
    ref, ref_info = tota.ota_aggregate_packed(JaxDraws(3), c["rows_t"], bits, _t(c["w"]),
                                              c["lt"], cfg, gains=g)
    ref_acc = tota.ota_aggregate_packed.last_acc
    got, info = tota.ota_aggregate_packed(JaxDraws(3), c["rows_t"], bits, _t(c["w"]), c["lt"],
                                          cfg, gains=g, mesh=_mesh(shards))
    assert _bytes_equal(tota.ota_aggregate_packed.last_acc, ref_acc)
    for k in ref:
        assert _bytes_equal(got[k], ref[k]), k
    assert dict(info) == dict(ref_info)
    jinfo = c["jinfo"]
    assert info["participation"] == jinfo["participation"]
    assert info["uplink_bytes"] == jinfo["uplink_bytes"]
    np.testing.assert_allclose(info["noise_std"], jinfo["noise_std"], rtol=1e-4)


def test_one_shard_mesh_is_byte_identical():
    c = _ota_case("per_row")
    bits = [r.bits for r in c["rows_t"]]
    a, _ = tota.ota_aggregate_packed(JaxDraws(9), c["rows_t"], bits, _t(c["w"]), c["lt"])
    b, _ = tota.ota_aggregate_packed(JaxDraws(9), c["rows_t"], bits, _t(c["w"]), c["lt"],
                                     mesh=_mesh(1))
    assert all(_bytes_equal(a[k], b[k]) for k in a)


def test_sharded_fold_pads_and_trims_to_the_layout():
    """At 5 shards the layout's 4,096 columns chunk to 832 (a multiple of
    the lcm of 2 and 64): the last chunk holds 768 columns and 64 of
    padding (zero symbols, unit scales), trimmed after the gather; the span
    reports the chunk and every group bumps its row counter."""
    c = _ota_case("mixed")
    kinds, datas, scales, _ = tota._group_rows(c["rows_t"])
    assert c["lt"].padded_size == 4096 and tota._shard_chunk(4096, 5, kinds) == 832
    before = obs.metrics.get("ota.rows", 0.0, kind="int4")
    with obs.enabled() as tr:
        out = tota._fold_groups(None, kinds, datas, scales, _t(c["wg"]), mesh=_mesh(5))
    assert out.shape == (c["lt"].padded_size,) and out.is_contiguous()
    (ev,) = [e for e in tr.events if e.name == "shard_fold"]
    assert ev.args == {"shards": 5, "groups": 4, "chunk": 832}
    assert obs.metrics.get("ota.rows", 0.0, kind="int4") == before + 2


@pytest.mark.parametrize("shards", [2, 5, 8])
def test_sharded_accumulator_over_waves_with_staleness_and_gains(shards):
    """Three waves (the later ones stale, the last with gains) through
    ``OtaAccumulator(mesh=)``: the state byte for byte the unsharded
    accumulator's and the reference's accumulator run op by op; the
    finalized tree byte for byte the unsharded one's."""
    rng = np.random.RandomState(11)
    lj = jpacking.make_layout({"a": jnp.zeros((2500,), jnp.float32)})
    lt = tpacking.make_layout({"a": torch.zeros(2500)})
    sr = JaxDraws(5).sr_seed
    rows_j, rows_t = [], []
    for j, b in enumerate([8, 8, 4, 4, 16, 32, 8, 4]):
        full = np.zeros(lj.padded_size, np.float32)
        full[: lj.size] = rng.randn(lj.size).astype(np.float32)
        rows_j.append(jwire.encode_row(jnp.asarray(full), b, jnp.uint32(sr), j, block=64))
        rows_t.append(twire.encode_row(_t(full), b, sr, j, block=64))
    w = (rng.rand(8) + 0.5).astype(np.float32)
    waves = [(slice(0, 3), None, None), (slice(3, 6), [0.9, 0.8, 0.7], None),
             (slice(6, 8), [0.6, 0.5], np.array([0.8, 1.1], np.float32))]

    def run_port(mesh):
        acc = tota.OtaAccumulator(lt, mesh=mesh)
        for sl, stale, g in waves:
            acc.fold(rows_t[sl], _t(w[sl]), staleness=stale, gains=None if g is None else _t(g))
        return acc

    ref, got = run_port(None), run_port(_mesh(shards))
    assert _bytes_equal(got.accumulator, ref.accumulator)
    accj = jota.OtaAccumulator(lj, use_kernel=False)
    with jax.disable_jit():
        for sl, stale, g in waves:
            accj.fold(rows_j[sl], jnp.asarray(w[sl]), staleness=stale,
                      gains=None if g is None else jnp.asarray(g))
        eager = np.asarray(accj.accumulator)
    assert _bytes_equal(got.accumulator, eager)
    a, ia = ref.finalize(JaxDraws(5))
    b, ib = got.finalize(JaxDraws(5))
    assert _bytes_equal(b["a"], a["a"]) and dict(ib) == dict(ia)


def test_float_matrix_takes_no_mesh():
    """The reference asserts where the port raises: ``mesh=`` is a packed-
    uplink feature; ``ota_aggregate`` takes no ``mesh`` in either package."""
    X = np.random.RandomState(0).randn(3, 512).astype(np.float32)
    lt = tpacking.make_layout({"a": torch.zeros(512)})
    lj = jpacking.make_layout({"a": jnp.zeros((512,), jnp.float32)})
    with pytest.raises(ValueError, match="mesh= is a packed-uplink feature"):
        tota.ota_aggregate_packed(JaxDraws(1), _t(X), [8, 8, 8], np.ones(3, np.float32), lt,
                                  mesh=_mesh(2))
    with pytest.raises(AssertionError, match="mesh= is a packed-uplink feature"):
        jota.ota_aggregate_packed(jax.random.key(1), jnp.asarray(X), [8, 8, 8],
                                  np.ones(3, np.float32), lj, mesh=object())
    assert "mesh" not in inspect.signature(tota.ota_aggregate).parameters
    assert "mesh" not in inspect.signature(jota.ota_aggregate).parameters


# (M, shards, (kind, qblock) keys): the reference's cases and the barrier
# round's DeepSpeech2 layout at 4 and 5 shards
CHUNK_CASES = [
    (4096, 8, (("int8", 64),)),
    (4096, 8, (("int8", 64), ("int16", 96))),
    (101, 8, (("int4", 0),)),
    (3328, 8, (("int8", 64),)),
    (1000, 4, (("int8", 128),)),
    (17, 8, (("int8", 0),)),
    (4134912, 4, (("int4", 256), ("int8", 256), ("int16", 256))),
    (4134912, 5, (("int4", 256), ("int8", 256), ("int16", 256))),
]


@pytest.mark.parametrize("M,n,kinds", CHUNK_CASES)
def test_shard_chunk_equals_the_reference(M, n, kinds):
    mc = tota._shard_chunk(M, n, kinds)
    assert mc == jota._shard_chunk(M, n, kinds)
    assert mc * n >= M and mc % 2 == 0
    for _, qb in kinds:
        assert qb == 0 or mc % qb == 0
    if M == 4134912:
        assert mc == {4: 1033728, 5: 827136}[n]


# ---------------------------------------------------------------- round loops

KNOB_CFG = dict(n_clients=6, clients_per_round=3, n_rounds=2, local_steps=1, local_batch=2,
                lr=1e-3, planner="unified", seed=0)
KNOB_ARCH = dict(n_layers=1, d_model=32)


@pytest.mark.parametrize("loop", ["barrier", "streaming"])
def test_mesh_knob_leaves_both_round_loops_bitwise(loop):
    """``mesh_data_shards`` 4 against 0 over two rounds (the reference's
    ``test_fl_server_mesh_knob_round_bitwise`` at its sizes, on a 1-layer
    width-32 DeepSpeech2): params byte for byte. The streaming loop runs the
    fading channel with a late wave, so its folds carry staleness and
    gains."""
    arch = get_arch("deepspeech2").with_(**KNOB_ARCH)

    def run(shards):
        if loop == "barrier":
            srv = FLServer(FLConfig(**KNOB_CFG, mesh_data_shards=shards), arch, device="cpu",
                           shard_size=6)
        else:
            cfg = FLConfig(**KNOB_CFG, mesh_data_shards=shards, channel_model="fading")
            srv = StreamingFLServer(cfg, arch, device="cpu", shard_size=6, fill_fraction=0.5,
                                    grace_s=0.3, latency=LatencyModel.with_tail(5.0))
        waves = []
        for r in range(2):
            srv.run_round(r)
            waves.append(len(srv.last_round.get("waves", [None])))
        return srv, waves

    a, wa = run(0)
    b, wb = run(4)
    assert a.mesh is None and b.mesh.shape == {"data": 4}
    assert b.mesh.devices == (torch.device("cpu"),) * 4
    assert wa == wb
    if loop == "streaming":
        assert max(wb) == 2
    for x, y in zip(jax.tree.leaves(convert.params_to_numpy(a.params)),
                    jax.tree.leaves(convert.params_to_numpy(b.params))):
        assert x.tobytes() == y.tobytes()


# ---------------------------------------------------------------- retrieval

# the reference's cases: (n, k, storage, integer grid, seed)
RET_CASES = {
    "f32_ragged": (1000, 16, "f32", False, 0),
    "tied_grid": (640, 20, "f32", True, 1),
    "k_past_shard": (300, 100, "f32", False, 2),
    "int8": (2000, 32, "int8", False, 3),
}


@functools.lru_cache(maxsize=None)
def _ret_case(name):
    n, k, storage, grid, seed = RET_CASES[name]
    rng = np.random.RandomState(seed)
    if grid:
        base = rng.randint(-3, 4, size=(n // 16, 64)).astype(np.float32)
        vecs = np.concatenate([base] * 16)  # heavy ties, exact dots
        qm = rng.randint(-3, 4, size=(4, 64)).astype(np.float32)
    else:
        vecs = normalize_rows(rng.randn(n, 64))
        qm = normalize_rows(rng.randn(5, 64))
    ts, js = TArena(64, storage=storage), JArena(64, storage=storage)
    ts.add_batch(vecs)
    js.add_batch(vecs)
    data, scales = js.raw()
    sj, ij = jops.topk_cosine(jnp.asarray(qm), jnp.asarray(data),
                              None if scales is None else jnp.asarray(scales), jnp.int32(n), k=k,
                              use_kernel=False)
    td, tsc = ts.raw()
    s0, i0 = ttk.topk_cosine(_t(qm), _t(td), None if tsc is None else _t(tsc), n, k=k)
    return dict(store=ts, qm=qm, k=k, n=n, grid=grid, sj=np.asarray(sj), ij=np.asarray(ij),
                s0=s0.numpy(), i0=i0.numpy())


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", sorted(RET_CASES))
def test_sharded_topk_equals_the_unsharded_topk(case, shards):
    """``RetrievalEngine(mesh=)`` and ``ops.topk_cosine_sharded``: scores
    and indices byte for byte the unsharded top-k's; indices byte for byte
    the reference's jitted top-k, scores too on the integer grid."""
    c = _ret_case(case)
    store, qm, k = c["store"], c["qm"], c["k"]
    eng = RetrievalEngine(store, device="cpu", mesh=_mesh(shards))
    with obs.enabled() as tr:
        s1, i1 = eng.topk(qm, k)
    (ev,) = [e for e in tr.events if e.name == "shard_merge"]
    assert ev.args == {"shards": shards, "k": k}
    assert _bytes_equal(s1, c["s0"]) and _bytes_equal(i1, c["i0"])
    # the capacity slab padded to shards x shard_rows, straight to the op
    data, scales = store.raw()
    pad = shards * store.shard_rows(shards) - data.shape[0]
    dp = np.concatenate([data, np.zeros((pad, 64), data.dtype)])
    sp = None if scales is None else np.concatenate([scales, np.ones((pad, 1), np.float32)])
    s2, i2 = tops.topk_cosine_sharded(_t(qm), _t(dp), None if sp is None else _t(sp), c["n"],
                                      k=k, mesh=_mesh(shards))
    assert _bytes_equal(s2, c["s0"]) and _bytes_equal(i2, c["i0"])
    assert (i2 < c["n"]).all() and torch.isfinite(s2).all()  # only live records selected
    assert _bytes_equal(i1, c["ij"])
    if c["grid"]:
        assert _bytes_equal(s1, c["sj"])
        sb, ib = brute_force_topk(store.vectors(), qm, k)
        assert _bytes_equal(s1, sb) and _bytes_equal(i1, ib)
    else:
        np.testing.assert_allclose(s1, c["sj"], rtol=0, atol=1e-6)


def test_retrieval_one_shard_mesh_is_byte_identical():
    rng = np.random.RandomState(4)
    store = TArena(64)
    store.add_batch(normalize_rows(rng.randn(512, 64)))
    qm = normalize_rows(rng.randn(5, 64))
    a = RetrievalEngine(store, device="cpu").topk(qm, 8)
    b = RetrievalEngine(store, device="cpu", mesh=_mesh(1)).topk(qm, 8)
    assert _bytes_equal(a[0], b[0]) and _bytes_equal(a[1], b[1])


def test_sharded_topk_runs_empty_trailing_shards_with_count_zero(monkeypatch):
    """n 300 over 8 shards of 256 rows: shards 2-7 hold no live record and
    run with count 0, returning -inf entries that the merge never takes
    while k <= n; with k > n the merge's -inf tail is the unsharded tail,
    indices from n up."""
    rng = np.random.RandomState(2)
    store = TArena(64)
    store.add_batch(normalize_rows(rng.randn(300, 64)))
    data, _ = store.raw()
    dp = np.concatenate([data, np.zeros((2048 - data.shape[0], 64), np.float32)])
    qm = _t(normalize_rows(rng.randn(3, 64)))
    calls = []
    orig = ttk.topk_plain

    def spy(q, r, sc, n, k):
        calls.append(n)
        return orig(q, r, sc, n, k)

    monkeypatch.setattr(ttk, "topk_plain", spy)
    s, i = tops.topk_cosine_sharded(qm, _t(dp), None, 300, k=100, mesh=_mesh(8))
    assert calls == [256, 44, 0, 0, 0, 0, 0, 0]
    assert torch.isfinite(s).all() and (i < 300).all()
    s0, i0 = orig(qm, _t(dp), None, 100, 128)
    s1, i1 = tops.topk_cosine_sharded(qm, _t(dp), None, 100, k=128, mesh=_mesh(8))
    assert _bytes_equal(s1, s0) and _bytes_equal(i1, i0)
    assert i1[0, 127] == 127 and torch.isinf(s1[:, 100:]).all()


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_arena_shard_helpers_equal_the_reference(storage, n_shards):
    rng = np.random.RandomState(n_shards)
    for cap, n in ((1024, 700), (16384, 3000), (256, 10)):
        ts = TArena(64, storage=storage, capacity=cap)
        js = JArena(64, storage=storage, capacity=cap)
        vecs = rng.randn(n, 64).astype(np.float32)
        ts.add_batch(vecs)
        js.add_batch(vecs)
        assert ts.shard_rows(n_shards) == js.shard_rows(n_shards)
        assert ts.shard_bounds(n_shards) == js.shard_bounds(n_shards)
        assert ts.shard_nbytes(n_shards) == js.shard_nbytes(n_shards)
        bounds = ts.shard_bounds(n_shards)
        assert bounds[0][0] == 0 and bounds[-1][1] == ts.capacity
        assert all(lo % ttk.TILE_N == 0 and lo <= hi for lo, hi in bounds)
        assert all(hi == lo2 for (_, hi), (lo2, _) in zip(bounds, bounds[1:]))
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        ts.shard_rows(0)


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_host_sharded_engine_equals_brute_force(n_shards):
    """The host-sharded numpy path on an integer grid (every GEMM exact):
    directly at k 20, and through ``topk`` past the kernel's k limit."""
    rng = np.random.RandomState(7)
    base = rng.randint(-3, 4, size=(40, 64)).astype(np.float32)
    vecs = np.concatenate([base] * 16)
    qm = rng.randint(-3, 4, size=(4, 64)).astype(np.float32)
    store = TArena(64)
    store.add_batch(vecs)
    eng = RetrievalEngine(store, device="cpu", n_shards=n_shards)
    for k, (s, i) in ((20, eng._topk_numpy_sharded(qm, 20)), (300, eng.topk(qm, 300))):
        sb, ib = brute_force_topk(store.vectors(), qm, k)
        np.testing.assert_array_equal(s, sb)
        np.testing.assert_array_equal(i, ib)


def test_merge_candidates_tie_contract():
    s_a, i_a = np.array([[3.0, 1.0]], np.float32), np.array([[0, 5]], np.int32)
    s_b, i_b = np.array([[3.0, 2.0]], np.float32), np.array([[7, 9]], np.int32)
    s, i = merge_candidates([s_a, s_b], [i_a, i_b], 3)
    np.testing.assert_array_equal(s, [[3.0, 3.0, 2.0]])
    np.testing.assert_array_equal(i, [[0, 7, 9]])
    sj, ij = jmerge([s_a, s_b], [i_a, i_b], 3)
    assert _bytes_equal(s, sj) and _bytes_equal(i, ij)
