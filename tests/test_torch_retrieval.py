"""Parity of the PyTorch port's retrieval and planning with the JAX
reference, on the CPU: the top-k (the kernel's plain version here; the
CUDA kernel is held against it on the card by ``chip_smoke.py``), the
arena storage classes, the engine, and the RAG planner's cohort
decisions across feedback rounds.

Records with equal feature dicts embed to identical vectors, so exact
score ties are common; the tie contract (score descending, equal scores
by ascending index) is what makes the decisions agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.profiling import hardware as jhw
from repro.core.profiling import planner as jplanner
from repro.core.profiling import users as jusers
from repro.kernels import ops as jops
from repro.retrieval.arena import ArenaStore as JArena
from repro.retrieval.engine import RetrievalEngine as JEngine
from repro_torch.core.profiling import hardware as thw
from repro_torch.core.profiling import planner as tplanner
from repro_torch.core.profiling import users as tusers
from repro_torch.kernels import topk_similarity as ttk
from repro_torch.retrieval.arena import ArenaStore as TArena
from repro_torch.retrieval.engine import RetrievalEngine as TEngine

D = 256
K = 32


def _slab(storage, n, cap, seed):
    """Unit vectors with duplicated records (exact ties) in both arenas."""
    rng = np.random.RandomState(seed)
    vec = rng.randn(n, D).astype(np.float32)
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    vec[300:340] = vec[10:50]  # duplicates across 256-record chunks
    vec[60:70] = vec[10:20]  # and inside one
    ja = JArena(D, storage=storage, capacity=cap)
    ta = TArena(D, storage=storage, capacity=cap)
    ja.add_batch(vec)
    ta.add_batch(vec)
    q = rng.randn(12, D).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:4] = vec[10:14]  # queries equal to duplicated records
    return ja, ta, q


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_arena_storage_exact(storage):
    ja, ta, _ = _slab(storage, 700, 1024, 0)
    jd, js = ja.raw()
    td, ts = ta.raw()
    np.testing.assert_array_equal(td, jd)
    if storage == "int8":
        np.testing.assert_array_equal(ts, js)
    assert (ta.capacity, len(ta), ta.nbytes) == (ja.capacity, len(ja), ja.nbytes)


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("n,cap", [(700, 1024), (1024, 1024), (1500, 2048)])
def test_topk_matches_jitted_oracle(storage, n, cap):
    """indices exact (ties included, n < Np), scores within 1e-6."""
    ja, ta, q = _slab(storage, n, cap, n)
    data, scales = ja.raw()
    sj, ij = jops.topk_cosine(jnp.asarray(q), jnp.asarray(data),
                              None if scales is None else jnp.asarray(scales),
                              jnp.int32(n), k=K, use_kernel=False)
    td, ts = ta.raw()
    st, it = ttk.topk_cosine(torch.from_numpy(q), torch.from_numpy(td),
                             None if ts is None else torch.from_numpy(ts), n, k=K)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)
    # the duplicated query's best hits are an exact tie, lowest index first
    assert st[0, 0] == st[0, 1] and it[0, 0] < it[0, 1]


def test_topk_matches_interpret_mode_kernel():
    """The Pallas kernel itself (interpret mode) on one small slab."""
    ja, ta, q = _slab("f32", 400, 512, 3)
    data, _ = ja.raw()
    sj, ij = jops.topk_cosine(jnp.asarray(q), jnp.asarray(data), None,
                              jnp.int32(400), k=K, use_kernel=True)
    td, _ = ta.raw()
    st, it = ttk.topk_cosine(torch.from_numpy(q), torch.from_numpy(td), None, 400, k=K)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)


def test_plain_topk_tail_past_live_count():
    """Entries past the live count are -inf with ascending indices."""
    ta = TArena(D, capacity=256)
    ta.add_batch(np.eye(D, dtype=np.float32)[:5])
    td, _ = ta.raw()
    s, i = ttk.topk_cosine(torch.eye(D)[:1], torch.from_numpy(td), None, 5, k=8)
    assert i[0, :5].tolist() == [0, 1, 2, 3, 4]
    assert torch.isinf(s[0, 5:]).all() and i[0, 5:].tolist() == [5, 6, 7]


def _tie_heavy_scores(seed, Q=6, N=600):
    """Sparse scores: many exact ties (zeros most of all), +-0.0, -inf tails."""
    rng = np.random.RandomState(seed)
    s = rng.choice(np.float32([0.5, 0.25, -0.25, 1.0, -1.0, 3e-39, -3e-39]), (Q, N))
    s[rng.rand(Q, N) < 0.5] = 0.0
    s[rng.rand(Q, N) < 0.2] = -0.0
    s[:, N - 50:] = -np.inf  # positions past a live count
    s[0, :] = 0.0  # a row of ties only
    s[1, ::2] = -0.0
    return torch.from_numpy(s.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_key_order_is_the_stable_sort(seed):
    """Descending order of the kernel's 64-bit key is torch.sort(stable=True)
    by descending score: equal scores (+0.0 and -0.0 among them) by
    ascending index, -inf last."""
    s = _tie_heavy_scores(seed)
    idx = torch.arange(s.shape[1]).expand_as(s)
    key = ttk.sort_key(s, idx)
    by_key = torch.sort(key, dim=1, descending=True).indices
    _, by_score = torch.sort(s, dim=1, descending=True, stable=True)
    assert torch.equal(by_key, by_score)
    assert all(row.unique().numel() == row.numel() for row in key)  # a total order


def test_sort_key_is_the_kernels_unsigned_key_less_two_to_the_63():
    """The Python key against the kernel's make_key written out bit by bit in
    numpy (uint64): high word ~u for a negative score, u | 2^31 otherwise
    (-0.0 first mapped to +0.0), low word ~index."""
    s = _tie_heavy_scores(3).numpy()
    idx = np.broadcast_to(np.arange(s.shape[1], dtype=np.uint64), s.shape)
    u = np.where(s == 0, np.float32(0), s).view(np.uint32).astype(np.uint64)
    hi = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    want = (hi << np.uint64(32)) | (~idx & np.uint64(0xFFFFFFFF))
    got = ttk.sort_key(torch.from_numpy(s), torch.from_numpy(idx.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint64) ^ np.uint64(1 << 63), want)


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_engine_matches_numpy_engine(storage):
    ja, ta, q = _slab(storage, 900, 1024, 7)
    sj, ij = JEngine(ja, use_kernel=False).topk(q, K)
    st, it = TEngine(ta, device="cpu").topk(q, K)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    empty = TEngine(TArena(D), device="cpu").topk(q, K)
    assert empty[0].shape == (12, 0) and empty[1].shape == (12, 0)


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("k", [257, 300, 400])
def test_engine_past_the_kernel_limit_takes_the_reference_host_path(storage, k):
    """k above the kernel's MAX_K (256; k = 400 is every live record): the
    reference's numpy path, indices and scores bit-equal to the reference."""
    ja, ta, q = _slab(storage, 400, 512, k)
    sj, ij = JEngine(ja, use_kernel=False).topk(q, k)
    st, it = TEngine(ta, device="cpu").topk(q, k)
    assert st.shape == it.shape == (12, k)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(st.view(np.uint32), sj.view(np.uint32))
    assert st[0, 0] == st[0, 1] and it[0, 0] < it[0, 1]  # the tie contract


def test_engine_numpy_helpers_are_the_reference_helpers():
    """The port's private copies of the reference's numpy helpers give the
    same arrays on the same inputs."""
    from repro.retrieval import engine as je
    from repro_torch.retrieval import engine as te

    assert te.CHUNK_ROWS == je.CHUNK_ROWS
    rng = np.random.RandomState(3)
    vec = rng.randn(300, 16).astype(np.float32)
    vec[200:220] = vec[0:20]
    vec[5] = 0.0  # a zero row stays zero
    qs = rng.randn(6, 16).astype(np.float32)
    np.testing.assert_array_equal(te.normalize_rows(vec), je.normalize_rows(vec))
    for name, args in (("brute_force_topk", (vec, qs, 40)), ("stable_topk", (qs @ vec.T, 40)),
                       ("stable_topk", (qs @ vec.T, 300))):
        for got, want in zip(getattr(te, name)(*args), getattr(je, name)(*args)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    cand = [te.stable_topk(qs @ vec[lo:lo + 100].T, 30) for lo in (0, 100, 200)]
    cs, ci = [c[0] for c in cand], [c[1] + lo for c, lo in zip(cand, (0, 100, 200))]
    for got, want in zip(te.merge_candidates(cs, ci, 30), je.merge_candidates(cs, ci, 30)):
        np.testing.assert_array_equal(got, want)


def test_plan_cohort_decisions_exact_over_feedback_rounds():
    """Same users, fleet and feedback -> identical bit plans, 3 rounds."""
    n = 20
    pj = jplanner.RAGPlanner(strategy="fedavg", seed=0)
    pt = tplanner.RAGPlanner(strategy="fedavg", seed=0, device="cpu")
    uj, sj = jusers.make_users(n, seed=0), jhw.make_fleet(n, seed=0)
    ut, st = tusers.make_users(n, seed=0), thw.make_fleet(n, seed=0)
    for rnd in range(3):
        dj = jplanner.plan_round(pj.plan_cohort(uj, sj))
        dt = tplanner.plan_round(pt.plan_cohort(ut, st))
        assert [d.bits for d in dt] == [d.bits for d in dj], rnd
        assert [d.user_id for d in dt] == [d.user_id for d in dj]
        np.testing.assert_allclose([d.score_est for d in dt], [d.score_est for d in dj],
                                   rtol=0, atol=1e-6)
        for d, u, s in zip(dj, uj, sj):
            pj.observe_feedback(u, s, d.bits, jusers.satisfaction_score(u, s, d.bits),
                                jusers.true_performance(u, s, d.bits))
        for d, u, s in zip(dt, ut, st):
            pt.observe_feedback(u, s, d.bits, tusers.satisfaction_score(u, s, d.bits),
                                tusers.true_performance(u, s, d.bits))
    assert len(pt.cqf_db) == len(pj.cqf_db) == 3 * n
    q = np.stack([np.asarray(pt.hqp_db.arena.vectors()[i]) for i in range(4)])
    sj_, ij_ = pj.hqp_db.engine.topk(q, K)
    st_, it_ = pt.hqp_db.engine.topk(q, K)
    np.testing.assert_array_equal(it_, ij_)


def test_engine_device_defaults_to_cuda():
    """No device and no card: the engine refuses to run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(TArena(D))

