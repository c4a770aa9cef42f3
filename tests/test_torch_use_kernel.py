"""The data plane's ``use_kernel=`` keyword, on the CPU: each of the six
entry points that take it in the reference (``ota_aggregate_flat``,
``OtaAccumulator``, ``ota_aggregate_packed``, ``ota_aggregate``,
``RetrievalEngine`` and ``ArenaVectorStore``) takes False, True and None,
gives the same result each way (on CPU tensors every value runs the plain
versions), and equals the reference called with the same keyword: its jnp
or numpy path for False and None, its Pallas kernel in interpret mode for
True. Tolerances as the port's other data-plane tests: aggregates rtol
1e-4 / atol 1e-6 of their largest magnitude (the K-sum is reassociated),
top-k indices exact and scores within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ota as jota
from repro.core import packing as jpacking
from repro.core import wire as jwire
from repro.retrieval.arena import ArenaStore as JArena
from repro.retrieval.engine import RetrievalEngine as JEngine
from repro.retrieval.store import ArenaVectorStore as JStore
from repro_torch.core import ota as tota
from repro_torch.core import packing as tpacking
from repro_torch.core import wire as twire
from repro_torch.kernels import ota_fused as kota
from repro_torch.kernels import topk_similarity as ktk
from repro_torch.retrieval.arena import ArenaStore as TArena
from repro_torch.retrieval.engine import RetrievalEngine as TEngine
from repro_torch.retrieval.store import ArenaVectorStore as TStore
from test_torch_fl import JaxDraws

USE_KERNEL = [False, True, None]
M = 2048 + 300
BITS = [4, 8, 16, 32, 8]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


def _launches():
    return (kota.ota_superpose.launches, kota.ota_fold.launches,
            kota.ota_quantize_superpose.launches, ktk.topk_cosine.launches)


def _matrix(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(len(BITS), M) * 0.01).astype(np.float32)


def _cohort(seed=1, block=256):
    rng = np.random.RandomState(seed)
    rows_j, rows_t = [], []
    for i, b in enumerate(BITS):
        row = (rng.randn(M) * 0.01).astype(np.float32)
        rows_j.append(jwire.encode_row(jnp.asarray(row), b, jnp.uint32(0x5EED), i, block=block))
        rows_t.append(twire.encode_row(_t(row), b, 0x5EED, i, block=block))
    return rows_j, rows_t


WEIGHTS = np.array([1.0, 2.0, 0.5, 1.5, 3.0], np.float32)


@pytest.mark.parametrize("use_kernel", USE_KERNEL)
def test_ota_aggregate_flat_takes_use_kernel(use_kernel):
    X = _matrix()
    cfg = tota.OTAConfig()
    yj, hj, pj, nj = jax.jit(
        lambda k, x, b, w: jota.ota_aggregate_flat(k, x, b, w, cfg=jota.OTAConfig(), n_valid=M,
                                                   use_kernel=use_kernel))(
        jax.random.key(3), jnp.asarray(X), jnp.asarray(BITS, jnp.int32), jnp.asarray(WEIGHTS))
    before = _launches()
    y, habs, part, std, acc = tota.ota_aggregate_flat(JaxDraws(3), _t(X), BITS, WEIGHTS,
                                                      cfg=cfg, n_valid=M, use_kernel=use_kernel)
    assert _launches() == before
    base = tota.ota_aggregate_flat(JaxDraws(3), _t(X), BITS, WEIGHTS, cfg=cfg, n_valid=M,
                                   use_kernel=False)
    assert torch.equal(y, base[0]) and torch.equal(acc, base[4])
    np.testing.assert_array_equal(part.numpy(), np.asarray(pj))
    np.testing.assert_allclose(float(std), float(nj), rtol=1e-4)
    _close(y.numpy(), yj)


@pytest.mark.parametrize("use_kernel", USE_KERNEL)
def test_ota_aggregate_packed_takes_use_kernel(use_kernel):
    rows_j, rows_t = _cohort()
    layout_j = jpacking.make_layout({"w": jnp.zeros((M,), jnp.float32)})
    layout_t = tpacking.make_layout({"w": torch.zeros(M)})
    agg_j, info_j = jota.ota_aggregate_packed(jax.random.key(4), rows_j, BITS,
                                              jnp.asarray(WEIGHTS), layout_j,
                                              use_kernel=use_kernel)
    before = _launches()
    agg_t, info_t = tota.ota_aggregate_packed(JaxDraws(4), rows_t, BITS, WEIGHTS, layout_t,
                                              use_kernel=use_kernel)
    assert _launches() == before
    acc = tota.ota_aggregate_packed.last_acc
    base, _ = tota.ota_aggregate_packed(JaxDraws(4), rows_t, BITS, WEIGHTS, layout_t,
                                        use_kernel=False)
    assert torch.equal(agg_t["w"], base["w"]) and torch.equal(acc,
                                                              tota.ota_aggregate_packed.last_acc)
    assert info_t["participation"] == info_j["participation"]
    np.testing.assert_allclose(info_t["noise_std"], info_j["noise_std"], rtol=1e-4)
    _close(agg_t["w"].numpy(), agg_j["w"])


@pytest.mark.parametrize("use_kernel", USE_KERNEL)
def test_ota_aggregate_takes_use_kernel(use_kernel):
    """Update trees (the one-shot f32 path) and packed rows with a layout."""
    rng = np.random.RandomState(5)
    trees = [{"a": (rng.randn(40, 7) * 0.01).astype(np.float32),
              "b": (rng.randn(123) * 0.01).astype(np.float32)} for _ in BITS]
    agg_j, info_j = jota.ota_aggregate(jax.random.key(6),
                                       [jax.tree.map(jnp.asarray, t) for t in trees], BITS,
                                       jnp.asarray(WEIGHTS), use_kernel=use_kernel)
    tt = [jax.tree.map(_t, t) for t in trees]
    before = _launches()
    agg_t, info_t = tota.ota_aggregate(JaxDraws(6), tt, BITS, WEIGHTS, use_kernel=use_kernel)
    assert _launches() == before
    base, _ = tota.ota_aggregate(JaxDraws(6), tt, BITS, WEIGHTS, use_kernel=False)
    assert info_t["participation"] == info_j["participation"]
    for n in ("a", "b"):
        assert torch.equal(agg_t[n], base[n])
        _close(agg_t[n].numpy(), agg_j[n])
    rows_j, rows_t = _cohort(seed=7)
    layout_j = jpacking.make_layout({"w": jnp.zeros((M,), jnp.float32)})
    layout_t = tpacking.make_layout({"w": torch.zeros(M)})
    pj, _ = jota.ota_aggregate(jax.random.key(8), rows_j, BITS, jnp.asarray(WEIGHTS),
                               layout=layout_j, use_kernel=use_kernel)
    pt, _ = tota.ota_aggregate(JaxDraws(8), rows_t, BITS, WEIGHTS, layout=layout_t,
                               use_kernel=use_kernel)
    _close(pt["w"].numpy(), pj["w"])


@pytest.mark.parametrize("use_kernel", USE_KERNEL)
def test_ota_accumulator_takes_use_kernel(use_kernel):
    """Two waves (the second with staleness and gains) and the epilogue."""
    rows_j, rows_t = _cohort(seed=9)
    layout_j = jpacking.make_layout({"w": jnp.zeros((M,), jnp.float32)})
    layout_t = tpacking.make_layout({"w": torch.zeros(M)})
    stale, g = [0.8, 0.6], np.array([0.9, 0.7], np.float32)
    accj = jota.OtaAccumulator(layout_j, use_kernel=use_kernel)
    accj.fold(rows_j[:3], jnp.asarray(WEIGHTS[:3]))
    accj.fold(rows_j[3:], jnp.asarray(WEIGHTS[3:]), staleness=stale, gains=jnp.asarray(g))

    def port(uk):
        acc = tota.OtaAccumulator(layout_t, use_kernel=uk)
        assert acc.use_kernel is uk
        acc.fold(rows_t[:3], _t(WEIGHTS[:3]))
        acc.fold(rows_t[3:], _t(WEIGHTS[3:]), staleness=stale, gains=_t(g))
        return acc

    before = _launches()
    acct = port(use_kernel)
    assert _launches() == before
    assert torch.equal(acct.accumulator, port(False).accumulator)
    _close(acct.accumulator.numpy(), accj.accumulator)
    agg_j, _ = accj.finalize(jax.random.key(10))
    agg_t, _ = acct.finalize(JaxDraws(10))
    _close(agg_t["w"].numpy(), agg_j["w"])


def _slab(seed=11, n=700, D=128):
    rng = np.random.RandomState(seed)
    vec = rng.randn(n, D).astype(np.float32)
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    vec[300:320] = vec[10:30]  # exact ties across 256-record chunks
    q = rng.randn(6, D).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:2] = vec[10:12]
    return vec, q


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("use_kernel", USE_KERNEL)
def test_retrieval_engine_takes_use_kernel(use_kernel, storage):
    vec, q = _slab()
    ja, ta = JArena(128, storage=storage), TArena(128, storage=storage)
    ja.add_batch(vec)
    ta.add_batch(vec)
    sj, ij = JEngine(ja, use_kernel=use_kernel).topk(q, 24)
    eng = TEngine(ta, use_kernel=use_kernel, device="cpu")
    assert eng.use_kernel is use_kernel
    before = _launches()
    st, it = eng.topk(q, 24)
    assert _launches() == before
    sb, ib = TEngine(ta, use_kernel=False, device="cpu").topk(q, 24)
    np.testing.assert_array_equal(st.view(np.uint32), sb.view(np.uint32))
    np.testing.assert_array_equal(it, ib)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_kernel", USE_KERNEL)
def test_arena_vector_store_passes_use_kernel_on(use_kernel, tmp_path):
    """The store hands the keyword to its engine, and ``restore`` keeps it."""
    vec, q = _slab(seed=12, n=400)
    js = JStore(128, storage="int8", use_kernel=use_kernel)
    ts = TStore(128, storage="int8", use_kernel=use_kernel, device="cpu")
    for i, v in enumerate(vec):
        js.add_vec(v, {"id": i})
        ts.add_vec(v, {"id": i})
    assert ts.engine.use_kernel is use_kernel
    hj, ht = js.query_batch(q, 9), ts.query_batch(q, 9)
    assert [[r["id"] for _, r in row] for row in ht] == [[r["id"] for _, r in row] for row in hj]
    np.testing.assert_allclose([[s for s, _ in row] for row in ht],
                               [[s for s, _ in row] for row in hj], rtol=0, atol=1e-6)
    path = str(tmp_path / "store")
    ts.save(path)
    other = TStore(128, storage="int8", use_kernel=use_kernel, device="cpu")
    other.restore(path)
    assert other.engine.use_kernel is use_kernel and other.engine.device == ts.engine.device
    assert other.query_batch(q, 9) == ht
