"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests need a CUDA device and skip without one; on the H100
run them with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_kernels_cuda.py`` (``chip_smoke.py`` covers the same
ground at the main path's shapes)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import FLConfig, get_arch
from repro_torch.core import ota, wire
from repro_torch.fl.server import FLServer, StreamingFLServer
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.kernels import ota_fused as kota
from repro_torch.kernels import topk_similarity as ktk
from repro_torch.kernels.ota_aggregate import ota_aggregate_2d, ota_aggregate_plain
from repro_torch.kernels.qmatmul import DESIGNS, kernel_design, mismatch, qmatmul_plain
from repro_torch.kernels.qmatmul import qmatmul as kqmm
from repro_torch.kernels.quantize import fake_quant_2d, fake_quant_plain
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import serve
from repro_torch.models import layers as L
from repro_torch.retrieval.arena import ArenaStore
from repro_torch.serve import Request, ServeEngine
from repro_torch.util import use_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("qblock", [0, 256])
@pytest.mark.parametrize("bits", [4, 8, 16, 24, 32])
def test_superpose_fold_kernel_equals_plain(dev, bits, qblock):
    M, K = 10_000, 7
    gen = torch.Generator(device=dev).manual_seed(bits)
    rows = [wire.encode_row(torch.randn(M, generator=gen, device=dev) * 0.01, bits, 5, i,
                            block=qblock) for i in range(K)]
    kinds, datas, scales, _ = ota._group_rows(rows)
    (kind, qb), data, scale = kinds[0], datas[0], scales[0]
    w = torch.rand(K, generator=gen, device=dev)
    g = torch.rand(K, generator=gen, device=dev)
    acc = torch.randn(M, generator=gen, device=dev)
    for gains in (None, g):
        kw = dict(gains=gains, qblock=qb, packed4=kind == "int4")
        sup = kota.ota_superpose(data, scale, w, **kw)
        assert torch.equal(sup, kota.superpose_plain(data, scale, w, **kw))
        fold = kota.ota_fold(acc, data, scale, w, **kw)
        assert torch.equal(fold, kota.superpose_plain(data, scale, w, acc=acc, **kw))
        assert torch.equal(kota.ota_fold(torch.zeros_like(acc), data, scale, w, **kw), sup)


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_topk_kernel_equals_plain(dev, storage):
    rng = np.random.RandomState(0)
    vec = rng.randn(1500, 256).astype(np.float32)
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    vec[700:720] = vec[10:30]
    store = ArenaStore(256, storage=storage, capacity=2048)
    store.add_batch(vec)
    data, scales = store.raw()
    recs = torch.from_numpy(data).to(dev)
    sc = None if scales is None else torch.from_numpy(scales).to(dev)
    q = torch.from_numpy(vec[8:28].copy()).to(dev)
    s, i = ktk.topk_cosine(q, recs, sc, 1500, k=32)
    sp, ip = ktk.topk_plain(q, recs, sc, 1500, 32)
    assert torch.equal(i, ip) and torch.equal(s, sp)


def _sparse_slab(storage, n, Np, Q, seed, dev):
    """Sparse unit records and queries like the planner's hashed embeddings
    (D = 256, 4 nonzeros of +-1/2 each): most scores are exact ties, zeros
    most of all; records past n are left as the arena leaves them."""
    rng = np.random.RandomState(seed)

    def sparse(rows):
        v = np.zeros((rows, 256), np.float32)
        for r in range(rows):
            v[r, rng.choice(256, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
        return v

    store = ArenaStore(256, storage=storage, capacity=Np)
    store.add_batch(sparse(n))
    data, scales = store.raw()
    assert data.shape[0] == Np
    return (torch.from_numpy(sparse(Q)).to(dev), torch.from_numpy(np.ascontiguousarray(data)).to(dev),
            None if scales is None else torch.from_numpy(scales).to(dev))


@pytest.mark.parametrize("Q", [1, 20])
@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("k", [1, 32, 128, 256])
@pytest.mark.parametrize("n", [1, 40, 255, 256, 257, 3996])
def test_topk_kernel_equals_plain_on_tie_heavy_slabs(dev, n, k, storage, Q):
    """Scores and indices bit for bit (k > n included: -inf with ascending
    indices) on a slab of one chunk or several (the least capacity that holds
    n), and on a 4,096-record slab, most of whose chunks are past n."""
    for Np in sorted({max(256, -(-n // 256) * 256), 4096}):
        qm, recs, sc = _sparse_slab(storage, n, Np, Q, n * 7 + k, dev)
        s, i = ktk.topk_cosine(qm, recs, sc, n, k=k)
        sp, ip = ktk.topk_plain(qm, recs, sc, n, k)
        assert torch.equal(i, ip), Np
        assert torch.equal(s.view(torch.int32), sp.view(torch.int32)), Np


def test_topk_kernel_carries_nothing_between_calls(dev):
    """One launch a call, and calls in a row (several chunks, one chunk, then
    the first again) each equal the plain version: no state survives a
    call."""
    cases = [_sparse_slab("int8", 3996, 4096, 20, 1, dev) + (3996, 128),
             _sparse_slab("f32", 40, 256, 20, 2, dev) + (40, 32)]
    for qm, recs, sc, n, k in cases + cases[:1]:
        before = ktk.topk_cosine.launches
        s, i = ktk.topk_cosine(qm, recs, sc, n, k=k)
        assert ktk.topk_cosine.launches == before + 1
        sp, ip = ktk.topk_plain(qm, recs, sc, n, k)
        assert torch.equal(i, ip) and torch.equal(s, sp)


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_engine_topk_past_the_kernel_limit_on_the_card(dev, storage):
    """k = 300 on an engine whose slab lives on the card: the host path,
    equal to the CPU engine's answer; no kernel launch."""
    from repro_torch.retrieval import RetrievalEngine

    rng = np.random.RandomState(1)
    vec = rng.randn(700, 64).astype(np.float32)
    store = ArenaStore(64, storage=storage, capacity=1024)
    store.add_batch(vec / np.linalg.norm(vec, axis=1, keepdims=True))
    q = vec[:5] / np.linalg.norm(vec[:5], axis=1, keepdims=True)
    eng = RetrievalEngine(store, device=dev)
    eng.topk(q, 8)  # the slab goes to the card
    before = ktk.topk_cosine.launches
    s, i = eng.topk(q, 300)
    assert ktk.topk_cosine.launches == before and s.shape == i.shape == (5, 300)
    sc, ic = RetrievalEngine(store, device="cpu").topk(q, 300)
    np.testing.assert_array_equal(i, ic)
    np.testing.assert_array_equal(s, sc)


OTA_KINDS = {"int4": (7, None), "int8": (127, torch.int8), "int16": (32767, torch.int16),
             "int32": (2**30, torch.int32), "float32": (None, torch.float32)}


def _ota_group(kind, K, M, qblock, gen, dev, offset):
    """K rows of M symbols of one storage class (int4 as M / 2 packed bytes),
    their scales (per row, or one per qblock symbols), a base ``offset``
    elements past 16-byte alignment."""
    lim, dt = OTA_KINDS[kind]
    cols = M // 2 if kind == "int4" else M
    n = K * cols + offset
    if kind == "int4":
        flat = torch.randint(0, 256, (n,), generator=gen, device=dev).to(torch.uint8)
    elif kind == "float32":
        flat = torch.randn((n,), generator=gen, device=dev) * 1e-3
    else:
        flat = torch.randint(-lim, lim + 1, (n,), generator=gen, device=dev).to(dt)
    q = flat[offset:].view(K, cols)
    if qblock:
        scale = torch.rand((K, -(-M // qblock)), generator=gen, device=dev) * 1e-3 + 1e-6
    else:
        scale = torch.rand((K,), generator=gen, device=dev) * 1e-3 + 1e-6
    return q, scale


@pytest.mark.parametrize("layout", ["whole", "ragged", "unaligned"])
@pytest.mark.parametrize("K", [1, 2, 7])
@pytest.mark.parametrize("qblock", [0, 256, 100])
@pytest.mark.parametrize("kind", list(OTA_KINDS))
def test_superpose_and_fold_equal_plain_in_every_layout(dev, kind, qblock, K, layout):
    """Bit for bit with the plain version, with and without gains, and
    fold(zeros, b) == superpose(b): M a whole number of warp segments (32
    runs of 16 bytes), a ragged M (M % run != 0, a partial last segment), or
    rows, acc and their bases off 16-byte alignment; scales per row,
    blockwise in runs' multiples (256) or straddling runs (100)."""
    M = {"whole": 65_536, "ragged": 10_002 if kind == "int4" else 10_003,
         "unaligned": 20_002}[layout]
    off = 1 if layout == "unaligned" else 0
    gen = torch.Generator(device=dev).manual_seed(K * 131 + M + qblock)
    q, scale = _ota_group(kind, K, M, qblock, gen, dev, off)
    w = torch.rand((K,), generator=gen, device=dev)
    acc = torch.randn((M + off,), generator=gen, device=dev)[off:]
    assert (q.data_ptr() % 16 == 0) == (off == 0)
    for gains in (None, torch.rand((K,), generator=gen, device=dev)):
        kw = dict(gains=gains, qblock=qblock, packed4=kind == "int4")
        sup = kota.ota_superpose(q, scale, w, **kw)
        assert torch.equal(sup, kota.superpose_plain(q, scale, w, **kw))
        fold = kota.ota_fold(acc, q, scale, w, **kw)
        assert torch.equal(fold, kota.superpose_plain(q, scale, w, acc=acc, **kw))
        assert torch.equal(kota.ota_fold(torch.zeros_like(acc), q, scale, w, **kw), sup)


def test_round_on_the_card_launches_every_kernel(dev):
    cfg = FLConfig(n_clients=4, clients_per_round=4, local_steps=1, local_batch=2)
    srv = FLServer(cfg, get_arch("deepspeech2").with_(n_layers=1, d_model=32), shard_size=8)
    assert srv.device.type == "cuda"
    before = (kota.ota_superpose.launches, kota.ota_fold.launches, ktk.topk_cosine.launches)
    for r in range(2):
        log = srv.run_round(r)
        assert np.isfinite(log.train_loss)
    after = (kota.ota_superpose.launches, kota.ota_fold.launches, ktk.topk_cosine.launches)
    assert after[0] > before[0] and after[2] > before[2]


@pytest.mark.parametrize("m", [10_000, 10_003])
@pytest.mark.parametrize("bits", [2, 4, 8, 16, 24, 31, 32])
def test_quantize_superpose_kernel_equals_plain(dev, bits, m):
    """acc exact; sumsq within rtol 1e-5 of the plain sum (another
    summation order) and identical across two launches; M = 10,003 takes
    the unaligned edge path."""
    K = 7
    gen = torch.Generator(device=dev).manual_seed(bits)
    x = torch.randn((K, m), generator=gen, device=dev) * 0.01
    row_bits = [bits] * (K - 1) + [32]
    scale, qmax = ota._client_grid(row_bits, x.abs().amax(dim=1))
    w = torch.rand(K, generator=gen, device=dev)
    acc, ss = kota.ota_quantize_superpose(x, scale, qmax, w, 0xC0FFEE)
    acc2, ss2 = kota.ota_quantize_superpose(x, scale, qmax, w, 0xC0FFEE)
    acc_p, ss_p = kota.quantize_superpose_plain(x, scale, qmax, w, 0xC0FFEE)
    assert torch.equal(acc, acc_p)
    assert torch.equal(acc, acc2) and torch.equal(ss, ss2)
    assert abs(ss.item() - ss_p.item()) <= 1e-5 * abs(ss_p.item())


@pytest.mark.parametrize("m", [10_000, 10_003])
@pytest.mark.parametrize("K", [4001, 8000])
def test_quantize_superpose_past_one_launch_equals_plain(dev, K, m):
    """K above the per-launch row limit: one launch per 4,000-row chunk, each
    continuing the last; bit for bit with the one-pass plain version."""
    gen = torch.Generator(device=dev).manual_seed(K + m)
    bits = [(2, 4, 8, 16, 24, 31, 32)[i % 7] for i in range(K)]
    x = torch.randn((K, m), generator=gen, device=dev) * 0.01
    scale, qmax = ota._client_grid(bits, x.abs().amax(dim=1))
    w = torch.rand((K,), generator=gen, device=dev) / K
    before = kota.ota_quantize_superpose.launches
    acc, ss = kota.ota_quantize_superpose(x, scale, qmax, w, 0xBEEF)
    assert kota.ota_quantize_superpose.launches == before + -(-K // kota.QS_MAX_K)
    acc_p, ss_p = kota.quantize_superpose_plain(x, scale, qmax, w, 0xBEEF)
    assert torch.equal(acc, acc_p)
    assert abs(ss.item() - ss_p.item()) <= 1e-5 * abs(ss_p.item())


QS_UNROLL = 4  # rows a group of loads of the narrow layout in csrc/ota_quantize_superpose.cu


def _qs_rows(K, M, gen, dev, offset=0):
    """K rows of M at bits 2/4/8/16/24/31/32 in turn, with 32-bit
    (qmax == 0) rows first, last and inside the first group of loads; a
    base ``offset`` floats past 16-byte alignment."""
    bits = [(2, 4, 8, 16, 24, 31, 32)[i % 7] for i in range(K)]
    for i in (0, K - 1, QS_UNROLL // 2):
        if i < K:
            bits[i] = 32
    x = (torch.randn(K * M + offset, generator=gen, device=dev) * 0.01)[offset:].view(K, M)
    scale, qmax = ota._client_grid(bits, x.abs().amax(dim=1))
    return x, scale, qmax, torch.rand((K,), generator=gen, device=dev) / K


@pytest.mark.parametrize("M", [1, 3, 10_003, 262_147])
@pytest.mark.parametrize("K", [1, 3, QS_UNROLL + 1, 20, 4001, 8000])
def test_quantize_superpose_kernel_equals_plain_at_every_group_edge(dev, K, M):
    """Whole and partial groups of loads, a chunk of parameters past the
    first (K > 256), passes past one launch (K > 4,000), ragged M, in both
    layouts: acc bit for bit, sumsq within rtol 1e-5 and the same over two
    launches."""
    gen = torch.Generator(device=dev).manual_seed(K * 7 + M)
    x, scale, qmax, w = _qs_rows(K, M, gen, dev)
    acc_p, ss_p = kota.quantize_superpose_plain(x, scale, qmax, w, 0xA11CE)
    for wide in (False, True):
        acc, ss = kota.ota_quantize_superpose(x, scale, qmax, w, 0xA11CE, wide=wide)
        acc2, ss2 = kota.ota_quantize_superpose(x, scale, qmax, w, 0xA11CE, wide=wide)
        assert torch.equal(acc, acc_p), wide
        assert torch.equal(acc, acc2) and torch.equal(ss, ss2), wide
        assert abs(ss.item() - ss_p.item()) <= 1e-5 * abs(ss_p.item()), wide


@pytest.mark.parametrize("dM", [-1, 0, 3])
def test_quantize_superpose_equals_plain_at_the_layout_threshold(dev, dM):
    """M just under the wide layout's threshold (narrow) and at and past it
    (wide), by the wrapper's own choice: acc bit for bit, sumsq within rtol
    1e-5."""
    K, M = QS_UNROLL + 3, kota._QS_WIDE_M + dM
    gen = torch.Generator(device=dev).manual_seed(M)
    x, scale, qmax, w = _qs_rows(K, M, gen, dev)
    acc, ss = kota.ota_quantize_superpose(x, scale, qmax, w, 0xBEEF)
    acc_p, ss_p = kota.quantize_superpose_plain(x, scale, qmax, w, 0xBEEF)
    assert torch.equal(acc, acc_p)
    assert abs(ss.item() - ss_p.item()) <= 1e-5 * abs(ss_p.item())


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("with_sumsq", [False, True])
def test_quantize_superpose_launch_continues_acc_in_at_k0(dev, offset, with_sumsq, wide):
    """One launch from a given acc_in at global row k0 > 0, on rows whose
    base is 16-byte aligned or one float past it (element loads), in either
    layout, equals the plain version continuing the same sum."""
    K, M, k0 = 37, 10_000, 4_003
    gen = torch.Generator(device=dev).manual_seed(offset + 2 * with_sumsq)
    x, scale, qmax, w = _qs_rows(K, M, gen, dev, offset)
    acc_in = torch.randn((M,), generator=gen, device=dev)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    acc, ss = kota._qs_launch(x, scale, qmax, w, 0xF00D, acc_in, k0, with_sumsq, wide)
    acc_p, ss_p = kota.quantize_superpose_plain(x, scale, qmax, w, 0xF00D, acc_in=acc_in, k0=k0)
    assert torch.equal(acc, acc_p)
    if with_sumsq:
        assert abs(ss.item() - ss_p.item()) <= 1e-5 * abs(ss_p.item())
    else:
        assert ss is None


def _stream_cases(dev):
    """Per wrapper: (the input a stream writes, the wrapper's call on it,
    the plain version's call, how the two are held)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(5000, generator=gen, device=dev)
    xk = torch.randn((7, 3000), generator=gen, device=dev)
    w = torch.rand(7, generator=gen, device=dev)
    nz = torch.randn(3000, generator=gen, device=dev)
    q8 = torch.randint(-127, 128, (7, 3000), generator=gen, device=dev).to(torch.int8)
    s8 = torch.rand(7, generator=gen, device=dev) * 1e-3
    xq = torch.randn((4, 256), generator=gen, device=dev)
    wq, sq = ops.quantize_weights(torch.randn((256, 64), generator=gen, device=dev))
    scale, qmax = ota._client_grid([4, 8, 32, 16, 2, 24, 31], xk.abs().amax(dim=1))
    qm, recs, sc = _topk_slab_small(gen, dev)
    fq = torch.randn((1, 256, 2, 64), generator=gen, device=dev).to(torch.bfloat16)
    fkv = torch.randn((1, 256, 1, 64), generator=gen, device=dev).to(torch.bfloat16)
    s_fq = ops.fake_quant_scale(x, 8)
    exact = torch.equal
    return {
        "fake_quant_2d": (x, lambda t: fake_quant_2d(t, s_fq, 8),
                          lambda t: fake_quant_plain(t, s_fq, 8), exact),
        "ota_aggregate_2d": (xk, lambda t: ota_aggregate_2d(t, w, nz, 0.1),
                             lambda t: ota_aggregate_plain(t, w, nz, 0.1), exact),
        "qmatmul": (xq, lambda t: kqmm(t, wq, sq), lambda t: qmatmul_plain(t, wq, sq),
                    lambda a, b: mismatch(a, b, xq, wq, sq)["within"]),
        "ota_superpose": (q8, lambda t: kota.ota_superpose(t, s8, w),
                          lambda t: kota.superpose_plain(t, s8, w), exact),
        "ota_fold": (q8, lambda t: kota.ota_fold(nz, t, s8, w),
                     lambda t: kota.superpose_plain(t, s8, w, acc=nz), exact),
        "ota_quantize_superpose": (
            xk, lambda t: kota.ota_quantize_superpose(t, scale, qmax, w, 5)[0],
            lambda t: kota.quantize_superpose_plain(t, scale, qmax, w, 5)[0], exact),
        "topk_cosine": (recs, lambda t: ktk.topk_cosine(qm, t, sc, 1000, k=8)[1],
                        lambda t: ktk.topk_plain(qm, t, sc, 1000, 8)[1], exact),
        "flash_mha": (fq, lambda t: kfa.flash_mha(t, fkv, fkv),
                      lambda t: kfa.flash_attention_plain(t, fkv, fkv),
                      lambda a, b: kfa.mismatch(a, b)["within"]),
    }


def _topk_slab_small(gen, dev):
    vec = torch.randn((1000, 32), generator=gen, device=dev)
    store = ArenaStore(32, storage="f32", capacity=1024)
    store.add_batch((vec / vec.norm(dim=1, keepdim=True)).cpu().numpy())
    data, scales = store.raw()
    qm = torch.randn((3, 32), generator=gen, device=dev)
    return (qm / qm.norm(dim=1, keepdim=True), torch.from_numpy(np.ascontiguousarray(data)).to(dev),
            None if scales is None else torch.from_numpy(scales).to(dev))


@pytest.mark.parametrize("name", ["fake_quant_2d", "ota_aggregate_2d", "qmatmul", "ota_superpose",
                                  "ota_fold", "ota_quantize_superpose", "topk_cosine",
                                  "flash_mha"])
def test_wrapper_launches_on_the_current_stream(dev, name):
    """Inside ``torch.cuda.stream(s)``, right after a long wait on s and a
    copy on s that writes the wrapper's input, with no synchronisation
    between: the wrapper sees the written input (it launched on s, after
    the copy), so its result equals the plain version's on that input."""
    src, call, plain, same = _stream_cases(dev)[name]
    target = torch.zeros_like(src)
    torch.cuda.synchronize()
    s = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)  # tens of milliseconds of the card's time on s
        target.copy_(src)
        out = call(target)
    torch.cuda.synchronize()
    assert same(out, plain(src))


def test_flat_aggregate_on_the_card_launches_quantize_superpose(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    trees = [{"a": torch.randn(300, 7, generator=gen, device=dev) * 0.01,
              "b": torch.randn(50, generator=gen, device=dev)} for _ in range(5)]
    before = kota.ota_quantize_superpose.launches
    agg, info = ota.ota_aggregate(ota.TorchRoundDraws(1, dev), trees, [4, 8, 16, 32, 8],
                                  [1.0, 2.0, 3.0, 4.0, 5.0])
    assert kota.ota_quantize_superpose.launches == before + 1
    assert agg["a"].shape == (300, 7) and bool(torch.isfinite(agg["a"]).all())


def test_stream_round_on_the_card_folds_with_gains(dev, monkeypatch):
    cfg = FLConfig(n_clients=6, clients_per_round=6, local_steps=1, local_batch=2,
                   channel_model="fading", fade_threshold=0.3)
    srv = StreamingFLServer(cfg, get_arch("deepspeech2").with_(n_layers=1, d_model=32),
                            shard_size=8, fill_fraction=0.5, grace_s=0.3)
    seen = []
    fold_groups = ota._fold_groups

    def spy(*args, **kw):  # every wave's group folds get the gains column
        seen.append(kw.get("gains") is not None)
        return fold_groups(*args, **kw)

    monkeypatch.setattr(ota, "_fold_groups", spy)
    before = kota.ota_fold.launches
    for r in range(2):
        log = srv.run_round(r)
        assert np.isfinite(log.train_loss)
    assert kota.ota_fold.launches > before and seen and all(seen)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S", [256, 200])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_equals_plain(dev, dtype, D, S, G):
    H = 8
    gen = torch.Generator(device=dev).manual_seed(S + D + G)
    q = torch.randn((2, S, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((2, S, H // G, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((2, S, H // G, D), generator=gen, device=dev).to(dtype)
    before = kfa.flash_mha.launches
    out = kfa.flash_mha(q, k, v)
    assert kfa.flash_mha.launches == before + 1
    plain = kfa.flash_attention_plain(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    mm = kfa.mismatch(out, plain)  # per element and share, see kfa.TOL_*
    assert mm["within"], mm


# (B, Sq, Sk, H, KV, causal): one tile, Sq = 1 / 127 / 129 / 2,000 with
# Sk = Sq (causal), Sq > Sk, B = 3 with ragged S (every batch's data
# differs, so a read across batches shows), H / KV in {1, 4, 8}
HOPPER_CASES = [
    (1, 128, 128, 8, 8, False), (1, 128, 128, 8, 8, True),
    (1, 1, 1, 8, 1, True), (1, 127, 127, 8, 2, True), (2, 129, 129, 8, 8, True),
    (1, 2000, 2000, 8, 1, True), (2, 384, 256, 8, 2, True), (3, 200, 200, 8, 1, True),
    (3, 300, 384, 4, 1, False), (1, 1, 256, 8, 8, False), (2, 256, 512, 8, 2, False),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal", HOPPER_CASES)
@pytest.mark.parametrize("D", [64, 128])
def test_flash_hopper_kernel_equals_plain(dev, D, B, Sq, Sk, H, KV, causal):
    gen = torch.Generator(device=dev).manual_seed(B * 7 + Sq + Sk + D + H // KV)
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, Sk, KV, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, Sk, KV, D), generator=gen, device=dev).bfloat16()
    before = kfa.flash_mha.launches
    out = kfa.flash_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kfa.flash_mha.launches == before + 1
    assert kfa.kernel_design(q.dtype, D) == "flash_fwd_hopper"
    mm = kfa.mismatch(out, kfa.flash_attention_plain(q, k, v, causal=causal))
    assert mm["within"], mm


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, D) for D in (32, 80, 96, 112)]
                         + [(torch.float32, D) for D in kfa.HEAD_DIMS])
def test_flash_other_routes_keep_their_kernel(dev, dtype, D):
    """bf16 at D 32/80/96/112 and every float32 width stay on the kernels of
    before the Hopper route (flash_fwd_bf16, flash_fwd_f32), within the rule."""
    gen = torch.Generator(device=dev).manual_seed(D)
    q = torch.randn((2, 200, 8, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((2, 256, 2, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((2, 256, 2, D), generator=gen, device=dev).to(dtype)
    out = kfa.flash_mha(q, k, v, causal=True)
    want = "flash_fwd_f32" if dtype == torch.float32 else "flash_fwd_bf16"
    assert kfa.kernel_design(dtype, D) == want
    mm = kfa.mismatch(out, kfa.flash_attention_plain(q, k, v, causal=True))
    assert mm["within"], mm


def test_flash_launcher_route_table_is_kernel_design(dev):
    from repro_torch.kernels import _build

    lib = _build.library("flash_attention")
    for D in kfa.HEAD_DIMS:
        for dtype, code in kfa._DTYPE_CODE.items():
            assert kfa.DESIGNS[lib.flash_attention_design(D, code)] == kfa.kernel_design(dtype, D)
    assert lib.flash_attention_design(40, 1) == -1


def test_flash_wrapper_rejects_bad_inputs(dev):
    z = torch.zeros((1, 64, 2, 128), device=dev)
    before = kfa.flash_mha.launches
    with pytest.raises(ValueError):  # non-contiguous
        kfa.flash_mha(z.transpose(1, 2), z.transpose(1, 2), z.transpose(1, 2))
    with pytest.raises(ValueError):  # float16
        h = z.half()
        kfa.flash_mha(h, h, h)
    with pytest.raises(ValueError):  # head dim 192: wider than any instantiation
        w = torch.zeros((1, 64, 2, 192), device=dev)
        kfa.flash_mha(w, w, w)
    with pytest.raises(ValueError, match="tile-aligned Sk"):  # the reference's padding
        kfa.flash_mha(z, z, z, causal=False)
    assert kfa.flash_mha.launches == before  # no plain-version fallback, no launch
    with pytest.raises(ValueError):  # 3 KV heads for 4 query heads
        kfa.flash_mha(torch.zeros((1, 64, 4, 64), device=dev),
                      *(torch.zeros((1, 64, 3, 64), device=dev),) * 2)


@pytest.mark.parametrize("Sq,Sk,causal", [(256, 384, False), (200, 256, False),
                                          (384, 256, True), (130, 256, True)])
@pytest.mark.parametrize("D", [32, 80, 96, 112])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_equals_plain_at_every_width_and_mask(dev, dtype, D, Sq, Sk, causal):
    H, KV = 8, 2
    gen = torch.Generator(device=dev).manual_seed(Sq + Sk + D)
    q = torch.randn((2, Sq, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((2, Sk, KV, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((2, Sk, KV, D), generator=gen, device=dev).to(dtype)
    before = kfa.flash_mha.launches
    out = kfa.flash_mha(q, k, v, causal=causal)
    assert kfa.flash_mha.launches == before + 1
    plain = kfa.flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    mm = kfa.mismatch(out, plain)
    assert mm["within"], mm


@pytest.mark.parametrize("D", [1, 40, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_padded_head_width_equals_plain(dev, dtype, D):
    """A width the kernel does not instantiate runs zero-padded to the next
    one, with the true width's scale; the output is sliced back."""
    gen = torch.Generator(device=dev).manual_seed(D)
    q = torch.randn((1, 256, 4, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((1, 256, 2, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((1, 256, 2, D), generator=gen, device=dev).to(dtype)
    for causal in (True, False):
        out = kfa.flash_mha(q, k, v, causal=causal)
        assert out.shape == q.shape and out.is_contiguous()
        mm = kfa.mismatch(out, kfa.flash_attention_plain(q, k, v, causal=causal))
        assert mm["within"], mm


def test_flash_on_cpu_tensors_runs_plain_and_does_not_count(dev):
    before = kfa.flash_mha.launches
    x = torch.randn(1, 40, 2, 64)
    assert torch.equal(kfa.flash_mha(x, x, x), kfa.flash_attention_plain(x, x, x))
    assert kfa.flash_mha.launches == before


def test_serve_on_the_card_prefills_through_the_kernel(dev):
    cfg = get_arch("qwen3-8b").reduced().with_(n_kv_heads=2, param_dtype="bfloat16",
                                                compute_dtype="bfloat16")
    before = kfa.flash_mha.launches
    res = serve(cfg.with_(use_flash_kernel=True), batch=2, prompt_len=200, gen=6, device=dev)
    assert kfa.flash_mha.launches == before + cfg.n_layers
    assert res.all_finite and res.tokens.shape == (2, 6)
    plain = serve(cfg, batch=2, prompt_len=200, gen=1, device=dev, params=res.params)
    d = (torch.log_softmax(res.prefill_logits, -1)
         - torch.log_softmax(plain.prefill_logits, -1)).abs().max()
    assert float(d) <= 0.1  # two bf16 layers; the serve phase allows 0.2 for 36
    eng = ServeEngine(cfg, max_batch=2, cache_len=64, device=dev, params=res.params)
    for i in range(4):
        eng.submit(Request(i, np.arange(1, 9 + i, dtype=np.int32), max_new_tokens=5))
    assert len(eng.run_until_drained()) == 4


def test_whisper_serves_on_the_card_with_the_flash_prefill(dev):
    """whisper-tiny's widths (6 heads of 64: the Hopper route) at 2 layers
    each side and 300 frames: the decoder's causal self-attention prefill
    launches the kernel once a layer (the encoder and the cross-attention
    stay chunked); flash against the chunked prefill within the serve
    phase's 0.2 log-softmax bound (two bf16 layers); the engine drains and
    leaves ``enc_out`` at zero."""
    cfg = get_arch("whisper-tiny").with_(n_layers=2, encoder_layers=2, encoder_seq=300,
                                         vocab_size=4096, use_flash_kernel=True)
    assert kfa.kernel_design(torch.bfloat16, cfg.resolved_head_dim()) == "flash_fwd_hopper"
    before = kfa.flash_mha.launches
    res = serve(cfg, batch=2, prompt_len=256, gen=6, device=dev)
    assert kfa.flash_mha.launches == before + cfg.n_layers
    assert res.all_finite and res.tokens.shape == (2, 6)
    assert res.cache["enc_out"].shape == (2, 300, 384)
    plain = serve(cfg.with_(use_flash_kernel=False), batch=2, prompt_len=256, gen=1,
                  device=dev, params=res.params)
    assert kfa.flash_mha.launches == before + cfg.n_layers
    d = (torch.log_softmax(res.prefill_logits, -1)
         - torch.log_softmax(plain.prefill_logits, -1)).abs().max()
    assert float(d) <= 0.2
    eng = ServeEngine(cfg, max_batch=2, cache_len=64, device=dev, params=res.params)
    for i in range(3):
        eng.submit(Request(i, np.arange(1, 9 + i, dtype=np.int32), max_new_tokens=5))
    assert len(eng.run_until_drained()) == 3
    assert not eng.cache["enc_out"].any()


@pytest.mark.parametrize("use_kernel", [False, True, None])
def test_use_kernel_picks_the_kernel_or_the_plain_version_on_the_card(dev, use_kernel):
    """On CUDA tensors ``use_kernel=False`` launches nothing and gives the
    plain versions' results bit for bit; True and None launch the
    kernels: the flat path's quantize-superpose, the packed path's
    superpose and fold, the accumulator's and the engine's top-k."""
    gen = torch.Generator(device=dev).manual_seed(3)
    bits = [4, 8, 16, 32, 8]
    trees = [{"a": torch.randn(300, 7, generator=gen, device=dev) * 0.01,
              "b": torch.randn(50, generator=gen, device=dev)} for _ in bits]
    weights = [1.0, 2.0, 3.0, 4.0, 5.0]
    rows = [wire.encode_row(torch.randn(5000, generator=gen, device=dev) * 0.01, b, 5, i,
                            block=256) for i, b in enumerate(bits)]
    from repro_torch.core import packing

    layout = packing.make_layout({"w": torch.zeros(5000, device=dev)})

    def counts():
        return (kota.ota_quantize_superpose.launches, kota.ota_superpose.launches,
                kota.ota_fold.launches, ktk.topk_cosine.launches)

    def run(uk):
        flat, _ = ota.ota_aggregate(ota.TorchRoundDraws(1, dev), trees, bits, weights,
                                    use_kernel=uk)
        packed, _ = ota.ota_aggregate_packed(ota.TorchRoundDraws(2, dev), rows, bits, weights,
                                             layout, use_kernel=uk)
        acc = ota.OtaAccumulator(layout, use_kernel=uk).fold(rows[:2], torch.ones(2))
        acc.fold(rows[2:], torch.ones(3))
        return flat["a"], packed["w"], acc.accumulator

    before = counts()
    got = run(use_kernel)
    after = counts()
    if use_kernel is False:
        assert after == before
    else:
        assert after[0] == before[0] + 1 and after[1] == before[1] + 2
        assert after[2] > before[2]
    for a, b in zip(got, run(False)):
        if use_kernel is False:
            assert torch.equal(a, b)
        else:  # the same ops, the kernels' own summation order
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    rng = np.random.RandomState(0)
    vec = rng.randn(600, 128).astype(np.float32)
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    store = ArenaStore(128, storage="f32")
    store.add_batch(vec)
    from repro_torch.retrieval.engine import RetrievalEngine

    n0 = ktk.topk_cosine.launches
    s, i = RetrievalEngine(store, use_kernel=use_kernel, device=dev).topk(vec[:4], 16)
    assert ktk.topk_cosine.launches == n0 + (use_kernel is not False)
    sp, ip = RetrievalEngine(store, use_kernel=False, device=dev).topk(vec[:4], 16)
    assert ktk.topk_cosine.launches == n0 + (use_kernel is not False)
    np.testing.assert_array_equal(i, ip)
    np.testing.assert_array_equal(s, sp)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_ssm_families_serve_on_the_card(dev, arch):
    """The ssm family launches no flash kernel; the hybrid's shared block
    launches it once a segment. Both engines drain."""
    cfg = get_arch(arch).reduced().with_(n_layers=4, param_dtype="bfloat16",
                                          compute_dtype="bfloat16", use_flash_kernel=True)
    before = kfa.flash_mha.launches
    res = serve(cfg, batch=2, prompt_len=200, gen=6, device=dev)
    want = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    assert kfa.flash_mha.launches == before + want
    assert res.all_finite and res.tokens.shape == (2, 6)
    eng = ServeEngine(cfg, max_batch=2, cache_len=64, device=dev, params=res.params)
    for i in range(4):
        eng.submit(Request(i, np.arange(1, 9 + i, dtype=np.int32), max_new_tokens=5))
    assert len(eng.run_until_drained()) == 4


# ------------------------------------------- the kernel entry points (ops)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(1, 0), (1001, 1), (4096 * 12288, 0)])
def test_fake_quant_kernel_equals_plain(dev, n, offset, dtype, stochastic):
    """Small, ragged and unaligned (a view one element in), and a full
    Qwen3-8B MLP weight: bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(n)
    x = (torch.randn(n + offset, generator=gen, device=dev) * 0.05).to(dtype)[offset:]
    noise = (torch.rand(n + offset, generator=gen, device=dev)[offset:] if stochastic
             else None)
    for bits in (4, 8, 16):
        s = ops.fake_quant_scale(x, bits)
        out = fake_quant_2d(x, s, bits, noise)
        assert out.dtype == dtype and torch.equal(out, fake_quant_plain(x, s, bits, noise))


def test_fake_quant_entry_point_counts_and_repeats(dev):
    x = torch.randn((3, 5000), device=dev)
    before = fake_quant_2d.launches
    a = ops.fake_quant(x, 4, stochastic=True, generator=torch.Generator(device=dev).manual_seed(7))
    b = ops.fake_quant(x, 4, stochastic=True, generator=torch.Generator(device=dev).manual_seed(7))
    assert torch.equal(a, b) and fake_quant_2d.launches == before + 2
    with pytest.raises(TypeError):
        fake_quant_2d(x.half(), ops.fake_quant_scale(x, 8), 8)
    with pytest.raises(ValueError):
        fake_quant_2d(x.t(), ops.fake_quant_scale(x, 8), 8)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("M", [1, 4133, 4_133_952])
@pytest.mark.parametrize("K", [1, 7, 20])
def test_ota_aggregate_kernel_equals_plain(dev, K, M, offset):
    gen = torch.Generator(device=dev).manual_seed(K * M)
    x = torch.randn(K * M + offset, generator=gen, device=dev)[offset:].reshape(K, M)
    w = torch.rand(K, generator=gen, device=dev)
    noise = torch.randn(M + offset, generator=gen, device=dev)[offset:]
    for std in (0.1, torch.tensor(0.37, device=dev)):
        out = ota_aggregate_2d(x, w, noise, std)
        assert torch.equal(out, ota_aggregate_plain(x, w, noise, std))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [(4, 4096, 12288), (4, 12288, 4096), (16, 64, 48),
                                   (17, 300, 129), (37, 301, 130), (300, 4096, 1000),
                                   (1000, 4096, 12288), (8192, 4096, 12288),
                                   (8192, 12288, 4096), (1000, 4104, 1008), (17, 64, 16)])
def test_qmatmul_kernel_within_tolerance_of_plain(dev, dtype, M, K, N):
    """Decode (split k) and prefill tiles, ragged M, K and N (element loads
    at the edges; TMA's zero fill on the Hopper route), Qwen3-8B's MLP widths
    at prefill; two launches give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    q, s = ops.quantize_weights(torch.randn((K, N), generator=gen, device=dev) * 0.02)
    out = ops.qmatmul(x, q, s)
    mm = mismatch(out, qmatmul_plain(x, q, s), x, q, s)
    assert out.shape == (M, N) and mm["within"], mm
    assert torch.equal(out, ops.qmatmul(x, q, s))


def test_qmatmul_launcher_route_table_is_kernel_design(dev):
    lib = _build.library("qmatmul")
    buf = torch.zeros(1 << 16, device=dev)
    w8 = torch.zeros(1 << 16, dtype=torch.int8, device=dev)
    seen = set()
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        xb = buf.to(dtype)
        for M, K, N in ((4, 64, 16), (16, 64, 16), (17, 64, 16), (17, 100, 16), (17, 64, 24),
                        (8192, 4096, 12288), (1000, 4104, 1008)):
            for xo, wo in ((0, 0), (1, 0), (0, 1), (8, 16)):
                x, w = xb[xo:], w8[wo:]
                got = DESIGNS[lib.qmatmul_design(code, M, N, K, x.data_ptr(), w.data_ptr())]
                assert got == kernel_design(dtype, M, N, K, x, w), (dtype, M, K, N, xo, wo)
                seen.add(got)
    assert seen == set(DESIGNS)


def test_qmatmul_misaligned_view_takes_the_old_kernel(dev):
    """A contiguous bf16 x 2 bytes off alignment cannot be a TMA source: it
    runs qmm_bf16 (element loads), within the rule and bit-stable."""
    M, K, N = 300, 4096, 1024
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(M * K + 1, generator=gen, device=dev).to(torch.bfloat16)[1:].view(M, K)
    q, s = ops.quantize_weights(torch.randn((K, N), generator=gen, device=dev) * 0.02)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    assert kernel_design(x.dtype, M, N, K, x, q) == "bf16"
    before = kqmm.launches
    out = ops.qmatmul(x, q, s)
    mm = mismatch(out, qmatmul_plain(x, q, s), x, q, s)
    assert mm["within"], mm
    assert torch.equal(out, ops.qmatmul(x, q, s)) and kqmm.launches == before + 2


def test_qmatmul_int4_kernel_within_tolerance_of_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((4, 4096), generator=gen, device=dev).to(torch.bfloat16)
    p, s = ops.quantize_weights_int4(torch.randn((4096, 1024), generator=gen, device=dev))
    q = ops.unpack_int4(p)
    mm = mismatch(ops.qmatmul_int4(x, p, s), qmatmul_plain(x, q, s), x, q, s)
    assert mm["within"], mm


def test_ops_wrappers_reject_bad_inputs(dev):
    x = torch.randn((4, 64), device=dev)
    q, s = ops.quantize_weights(torch.randn((64, 32), device=dev))
    with pytest.raises(TypeError):
        ops.qmatmul(x.half(), q, s)
    with pytest.raises(ValueError):
        ops.qmatmul(x[:, :32], q, s)
    with pytest.raises(ValueError):
        ops.qmatmul(x, q, s.cpu())
    with pytest.raises(ValueError):
        ops.ota_aggregate(x, torch.ones(3, device=dev), torch.zeros(64, device=dev), 0.1)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_full_width_scan_equals_its_recurrence(dev, family):
    """The chunked scans at falcon-mamba's width (d_inner 8,192, N 16) and
    zamba2's (80 heads of 64, N 64) on the card, over 256 steps (4 chunks)
    from a random state, against the step-by-step recurrence at the
    reference tests' rtol/atol 1e-4; ``chip_smoke.py`` holds them on a
    prefill's own inputs."""
    from repro_torch.models import ssm as S

    gen = torch.Generator(device=dev).manual_seed(9)
    B, T = 2, 256

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    if family == "ssm":
        d, N = 8192, 16
        args = (rnd(B, T, d).abs() * 0.1, -(rnd(d, N).abs() + 0.1), rnd(B, T, N), rnd(B, T, N),
                rnd(B, T, d), rnd(B, d, N, scale=0.5))
        got, want = S._mamba1_chunked_scan(*args), S.mamba1_scan_plain(*args)
    else:
        H, P, N = 80, 64, 64
        args = (rnd(B, T, H, P), rnd(B, T, H).abs() * 0.2, -(rnd(H).abs() + 0.2), rnd(B, T, N),
                rnd(B, T, N), rnd(B, H, P, N, scale=0.5))
        got, want = S._ssd_scan(*args), S.ssd_scan_plain(*args)
    for a, e in zip(got, want):
        assert a.is_cuda and torch.isfinite(a).all()
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4)


def _mesh_on(dev, shards):
    from repro_torch.launch.mesh import make_data_mesh

    return make_data_mesh(shards, devices=[dev] * shards)


@pytest.mark.parametrize("shards", [2, 3, 4, 5])
@pytest.mark.parametrize("block", [0, 256])
def test_sharded_fold_through_the_kernel_equals_the_unsharded_kernel(dev, block, shards):
    """A mixed cohort (int4, int8, int16, f32 groups, gains) folded with the
    symbol axis over ``shards`` chunks on the card, then folded again onto
    that state: bit for bit the unsharded kernel path, shards x groups
    launches a fold. Per-row scales at 3 shards give chunks of 34,134
    columns, rows that are not 16-byte multiples (the kernel's scalar
    path)."""
    M = 102_400
    gen = torch.Generator(device=dev).manual_seed(block + shards)
    bits = [4, 8, 16, 32, 8, 4, 16]
    rows = [wire.encode_row(torch.randn(M, generator=gen, device=dev) * 0.01, b, 5, i,
                            block=block) for i, b in enumerate(bits)]
    kinds, datas, scales, _ = ota._group_rows(rows)
    w = torch.rand(len(bits), generator=gen, device=dev)
    g = torch.rand(len(bits), generator=gen, device=dev)
    mesh = _mesh_on(dev, shards)
    want = ota._fold_groups(None, kinds, datas, scales, w, gains=g)
    before = (kota.ota_superpose.launches, kota.ota_fold.launches)
    got = ota._fold_groups(None, kinds, datas, scales, w, gains=g, mesh=mesh)
    assert (kota.ota_superpose.launches - before[0], kota.ota_fold.launches - before[1]) == (
        shards, shards * (len(kinds) - 1))
    assert got.is_cuda and torch.equal(got.view(torch.int32), want.view(torch.int32))
    again = ota._fold_groups(got, kinds, datas, scales, w, gains=g, mesh=mesh)
    want2 = ota._fold_groups(want, kinds, datas, scales, w, gains=g)
    assert torch.equal(again.view(torch.int32), want2.view(torch.int32))


@pytest.mark.parametrize("shards", [2, 4, 5])
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_sharded_topk_through_the_kernel_equals_the_unsharded_kernel(dev, storage, shards):
    """``RetrievalEngine(mesh=)`` on the card over 7,192 live records of an
    8,192-record arena with duplicated records (exact ties), k 32 and 128:
    scores and indices bit for bit the unsharded kernel's, one launch a
    shard."""
    from repro_torch.retrieval import RetrievalEngine

    rng = np.random.RandomState(shards)
    n = 8192 - 1000
    vec = rng.randn(n, 256).astype(np.float32)
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    vec[4000:4100] = vec[10:110]  # duplicates in another shard
    store = ArenaStore(256, storage=storage, capacity=8192)
    store.add_batch(vec)
    data, scales = store.raw()
    recs = torch.from_numpy(data).to(dev)
    sc = None if scales is None else torch.from_numpy(scales).to(dev)
    q = vec[np.r_[10:20, 500:510]]
    eng = RetrievalEngine(store, device=dev, mesh=_mesh_on(dev, shards))
    for k in (32, 128):
        s0, i0 = ktk.topk_cosine(torch.from_numpy(q).to(dev), recs, sc, n, k=k)
        before = ktk.topk_cosine.launches
        s1, i1 = eng.topk(q, k)
        assert ktk.topk_cosine.launches == before + shards
        assert np.array_equal(i1, i0.cpu().numpy())
        assert s1.tobytes() == s0.cpu().numpy().tobytes()
        assert s1[0, 0] == s1[0, 1] and i1[0, 0] == 10 and i1[0, 1] == 4000


@pytest.mark.parametrize("k", [100, 128])
def test_sharded_topk_launches_empty_shards_with_count_zero(dev, k):
    """300 live records over 8 shards of 256 rows: shards 2-7 launch the
    kernel with count 0; k 128 > n leaves a -inf tail. Bit for bit the
    unsharded kernel, one launch a shard."""
    rng = np.random.RandomState(k)
    store = ArenaStore(64, capacity=1024)
    store.add_batch(rng.randn(300, 64).astype(np.float32))
    n = 100 if k == 128 else 300
    data, _ = store.raw()
    slab = torch.from_numpy(np.concatenate([data, np.zeros((1024, 64), np.float32)])).to(dev)
    q = torch.from_numpy(rng.randn(3, 64).astype(np.float32)).to(dev)
    s0, i0 = ktk.topk_cosine(q, slab, None, n, k=k)
    before = ktk.topk_cosine.launches
    s1, i1 = ops.topk_cosine_sharded(q, slab, None, n, k=k, mesh=_mesh_on(dev, 8),
                                     use_kernel=True)
    assert ktk.topk_cosine.launches == before + 8
    assert torch.equal(i1, i0) and torch.equal(s1.view(torch.int32), s0.view(torch.int32))


@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    return n


def test_data_mesh_across_cards(cards):
    """``make_data_mesh(n)`` over n distinct cards: the sharded fold, the
    sharded top-k and a ``FLServer(mesh_data_shards=n)`` round, each bit for
    bit the unsharded kernel path on card 0, one launch a shard."""
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.retrieval import RetrievalEngine

    dev = torch.device("cuda", 0)
    mesh = make_data_mesh(cards)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(cards))
    M = 102_400
    gen = torch.Generator(device=dev).manual_seed(cards)
    bits = [4, 8, 16, 32, 8, 4, 16]
    rows = [wire.encode_row(torch.randn(M, generator=gen, device=dev) * 0.01, b, 5, i,
                            block=256) for i, b in enumerate(bits)]
    kinds, datas, scales, _ = ota._group_rows(rows)
    w = torch.rand(len(bits), generator=gen, device=dev)
    g = torch.rand(len(bits), generator=gen, device=dev)
    want = ota._fold_groups(None, kinds, datas, scales, w, gains=g)
    before = (kota.ota_superpose.launches, kota.ota_fold.launches)
    got = ota._fold_groups(None, kinds, datas, scales, w, gains=g, mesh=mesh)
    assert (kota.ota_superpose.launches - before[0], kota.ota_fold.launches - before[1]) == (
        cards, cards * (len(kinds) - 1))
    assert got.device == dev and torch.equal(got.view(torch.int32), want.view(torch.int32))

    rng = np.random.RandomState(cards)
    n = 8192 - 1000
    vec = rng.randn(n, 256).astype(np.float32)
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    vec[4000:4100] = vec[10:110]
    store = ArenaStore(256, storage="int8", capacity=8192)
    store.add_batch(vec)
    data, sc = store.raw()
    q = vec[np.r_[10:20, 500:510]]
    s0, i0 = ktk.topk_cosine(torch.from_numpy(q).to(dev), torch.from_numpy(data).to(dev),
                             torch.from_numpy(sc).to(dev), n, k=32)
    before = ktk.topk_cosine.launches
    s1, i1 = RetrievalEngine(store, device=dev, mesh=mesh).topk(q, 32)
    assert ktk.topk_cosine.launches == before + cards
    assert np.array_equal(i1, i0.cpu().numpy()) and s1.tobytes() == s0.cpu().numpy().tobytes()

    arch = get_arch("deepspeech2").with_(n_layers=1, d_model=32)
    cfg = FLConfig(n_clients=6, clients_per_round=3, local_steps=1, local_batch=2, seed=0,
                   mesh_data_shards=cards)
    srv = FLServer(cfg, arch, device=dev, shard_size=6)
    assert srv.mesh.devices == mesh.devices
    srv.run_round(0)
    acc = ota.ota_aggregate_packed.last_acc
    last = srv.last_round
    ota.ota_aggregate_packed(last["draws"], last["rows"], None, last["weights"], srv.layout,
                             ota.OTAConfig(snr_db=cfg.snr_db))
    assert torch.equal(acc.view(torch.int32), ota.ota_aggregate_packed.last_acc.view(torch.int32))


class TestZoo:
    """The model zoo's mesh on the card (``-k zoo``): the MoE's
    expert-parallel branch against its plain version on four shards of one
    card, the placement by the specs, and the branch over four distinct
    cards."""

    # the branch runs each model shard's experts in their own batched
    # products, the plain version all in one: cuBLAS may sum in another
    # order, so bf16 outputs are held within 4 bf16 roundings (2^-8 each)
    # of the largest |out|, f32 within 1e-5 of it
    ULPS = {torch.bfloat16: 4 * 2.0 ** -8, torch.float32: 1e-5}

    @staticmethod
    def _moe(dev, dtype, d_ff=256, seed=0):
        """kimi-k2's router and experts (384 of them, top 8, d_model 7,168)
        at an expert width of ``d_ff``, and 4 x 512 tokens."""
        cfg = get_arch("kimi-k2-1t-a32b").with_(
            n_layers=1, moe_d_ff=d_ff, param_dtype=str(dtype).removeprefix("torch."),
            compute_dtype=str(dtype).removeprefix("torch."))
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = L.init_moe(gen, cfg, dtype, dev)
        x = torch.randn(4, 512, cfg.d_model, generator=gen, device=dev).to(dtype)
        return cfg, p, x

    def _check(self, out, plain, dtype):
        err = float((out.float() - plain.float()).abs().max())
        assert err <= self.ULPS[dtype] * float(plain.float().abs().max()), err
        assert bool(torch.isfinite(out).all())

    @pytest.mark.parametrize("dims", [(2, 2), (1, 4), (4, 1), (2, 2, 1)])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_zoo_moe_sharded_equals_plain_on_one_card(self, dev, dtype, dims):
        from repro_torch import obs

        cfg, p, x = self._moe(dev, dtype)
        axes = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
        mesh = make_mesh(dims, axes, devices=[dev] * int(np.prod(dims)))
        dp, mp = int(np.prod(dims[:-1])), dims[-1]
        with obs.enabled() as tracer, use_mesh(mesh):
            out, aux = L.moe_block(p, x, cfg)
        sharded = [e for e in tracer.events if e.name == "moe_shard_map"]
        if mp == 1:  # no model axis to parallelise over: the local path
            assert not sharded
            want = L.moe_block(p, x, cfg)
            assert torch.equal(out, want[0]) and torch.equal(aux, want[1])
            return
        assert len(sharded) == 1 and sharded[0].args["tokens"] == 2048 // dp
        plain, plain_aux = L.moe_sharded_plain(p, x, cfg, dp, mp)
        assert out.device == x.device and out.dtype == dtype
        self._check(out, plain, dtype)
        assert float(aux) == float(plain_aux)

    def test_zoo_placement_round_trips_on_one_card(self, dev):
        from repro_torch.core.tree import tree_leaves
        from repro_torch.launch.steps import init_train_state
        from repro_torch.models.registry import build_model
        from repro_torch.optim import adamw

        cfg = get_arch("stablelm-1.6b").with_(n_layers=2)
        state = init_train_state(build_model(cfg), adamw(1e-3),
                                 torch.Generator(device=dev).manual_seed(0))
        tree = {"params": state["params"], "opt": state["opt"]}
        mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
        specs = {"params": shd.tree_param_specs(tree["params"], mesh, n_kv_heads=cfg.n_kv_heads),
                 "opt": {k: shd.tree_param_specs(v, mesh, n_kv_heads=cfg.n_kv_heads)
                         for k, v in tree["opt"].items()}}
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        placed = shd.place(tree, shd.to_named(specs, mesh))
        grew = torch.cuda.memory_allocated(dev) - before
        per_dev = shd.device_nbytes(placed)
        assert (per_dev == shd.tree_spec_nbytes(tree, specs, mesh)).all()
        n_pieces = 4 * len(tree_leaves(tree))
        assert per_dev.sum() <= grew <= per_dev.sum() + 512 * n_pieces
        for a, b in zip(tree_leaves(tree), tree_leaves(shd.gather(placed))):
            assert b.device == dev and b.dtype == a.dtype
            assert torch.equal(b.reshape(-1).view(torch.uint8), a.reshape(-1).view(torch.uint8))

    def test_moe_expert_parallel_across_cards(self):
        """kimi-k2's MoE layer at full width on a (1, 4) mesh of four
        distinct cards: each card holds one model shard's 96 experts (8.5
        GB, placed by the specs) and runs them; held against the plain
        version on card 0."""
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 4:
            pytest.skip("needs four CUDA devices")
        dev = torch.device("cuda", 0)
        cfg = get_arch("kimi-k2-1t-a32b").with_(n_layers=1)
        gen = torch.Generator(device=dev).manual_seed(0)
        p = L.init_moe(gen, cfg, torch.bfloat16, dev)
        x = torch.randn(4, 2048, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
        mesh = make_mesh((1, 4), ("data", "model"))
        assert [d.index for d in mesh.devices.flat] == [0, 1, 2, 3]
        specs = shd.tree_param_specs({"moe": p}, mesh, n_kv_heads=cfg.n_kv_heads)["moe"]
        placed = shd.place(p, shd.to_named(specs, mesh))
        for m in range(4):
            piece = placed["w_gate"].pieces[0, m]
            assert piece.device == torch.device("cuda", m) and piece.shape[0] == 96
        assert int(shd.device_nbytes({k: placed[k] for k in ("w_gate", "w_up", "w_down")})
                   [0, 1]) == 3 * 96 * 7168 * 2048 * 2
        with use_mesh(mesh):
            out, aux = L.moe_block(placed, x, cfg)
        plain, plain_aux = L.moe_sharded_plain(p, x, cfg, 1, 4)
        assert out.device == dev
        self._check(out, plain, torch.bfloat16)
        assert float(aux) == float(plain_aux)


class TestShardTrain:
    """The sharded train step on the card (``-k shardtrain``): a reduced
    (2, 2) step on four shards of one card against the unsharded step
    under the same mesh, and qwen3-8b at full width and depth on a (2, 2)
    mesh of four distinct cards, whose train state does not fit one."""

    # f32, as tests/test_torch_sharded_train.py: metrics rtol 1e-6, f32
    # moments 1e-5 and params 1e-3 of each leaf's largest value
    F32 = {"metric": 1e-6, "moment": 1e-5, "param": 1e-3}
    # bf16 at full width, as chip_smoke.py's SHARD_LOSS_RTOL / SHARD_GNORM_RTOL
    BF16 = {"loss": 1e-4, "grad_norm": 1e-2}

    @staticmethod
    def _shardings(cfg, shapes, batch, mesh):
        from repro_torch.launch import steps

        specs = {"params": shd.tree_param_specs(shapes["params"], mesh,
                                                n_kv_heads=cfg.n_kv_heads),
                 "opt": {k: shd.tree_param_specs(v, mesh, n_kv_heads=cfg.n_kv_heads)
                         for k, v in shapes["opt"].items()}, "step": shd.P()}
        return (specs, shd.to_named(specs, mesh),
                shd.to_named(shd.batch_spec(batch, mesh), mesh), steps)

    @pytest.mark.parametrize("arch", ["stablelm-1.6b", "kimi-k2-1t-a32b"])
    def test_shardtrain_reduced_step_on_one_card(self, dev, arch):
        from repro_torch import obs
        from repro_torch.core.tree import tree_leaves
        from repro_torch.launch.steps import init_train_state, make_train_step
        from repro_torch.models.registry import build_model
        from repro_torch.optim import adamw

        cfg = get_arch(arch).reduced().with_(remat=True)
        model, opt = build_model(cfg), adamw(1e-3)
        state = init_train_state(model, opt, torch.Generator(device=dev).manual_seed(0))
        rng = np.random.RandomState(0)
        batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 64)),
                                           dtype=torch.int32, device=dev)}
        mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
        specs, s_sh, b_sh, steps = self._shardings(cfg, state, batch, mesh)
        with obs.enabled() as tracer:
            new, met = steps.make_sharded_train_step(model, opt, s_sh, b_sh)(state, batch)
        with use_mesh(mesh):
            want, want_m = make_train_step(model, opt)(state, batch)
        for k in want_m:
            rel = abs(float(met[k]) - float(want_m[k])) / max(abs(float(want_m[k])), 1e-30)
            assert rel <= self.F32["metric"], (k, rel)
        got = shd.gather(new)
        for group, tol in (("params", "param"), ("opt", "moment")):
            for a, b in zip(tree_leaves(got[group]), tree_leaves(want[group])):
                assert a.device == dev and a.dtype == b.dtype
                err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                assert err <= self.F32[tol], (group, err)
        assert (shd.device_nbytes(new) == shd.tree_spec_nbytes(state, specs, mesh)).all()
        assert all(p.device == dev for leaf in tree_leaves(new) for p in leaf.pieces.flat)
        spans = [e.args for e in tracer.events if e.name == "moe_shard_map"]
        if cfg.n_experts:  # forward and remat's recompute, each shard on its own row
            assert len(spans) == 2 * 2 * cfg.n_layers and all(s["dp"] == 1 for s in spans)
        else:
            assert not spans

    @pytest.mark.parametrize("tp", [False, True], ids=["gather", "tensorparallel"])
    def test_shardtrain_donated_bit_for_bit_on_one_card(self, dev, tp):
        """The donating step (``donate=True``) on a (2, 2) mesh of four
        shards of one card, two steps of stablelm reduced (f32, remat)
        with f32 and quantized AdamW moments: every piece and metric bit
        for bit the step without donation, every piece where it was; and
        the unsharded donating step likewise."""
        from repro_torch.core.tree import tree_leaves, tree_map
        from repro_torch.launch.steps import init_train_state, make_train_step
        from repro_torch.models.registry import build_model
        from repro_torch.optim import adamw

        cfg = get_arch("stablelm-1.6b").reduced().with_(remat=True)
        model = build_model(cfg)
        rng = np.random.RandomState(0)
        batches = [{"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 64)),
                                              dtype=torch.int32, device=dev)} for _ in range(2)]
        mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)

        def same(a, b):
            return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                                      b.reshape(-1).view(torch.uint8))

        for quant in (False, True):
            opt = adamw(1e-3, quantize=quant)
            state = init_train_state(model, opt, torch.Generator(device=dev).manual_seed(0))
            specs, s_sh, b_sh, steps = self._shardings(cfg, state, batches[0], mesh)
            plain = steps.make_sharded_train_step(model, opt, s_sh, b_sh, tensor_parallel=tp)
            donating = steps.make_sharded_train_step(model, opt, s_sh, b_sh, tensor_parallel=tp,
                                                     donate=True)
            want, got = shd.place(state, s_sh), shd.place(state, s_sh)
            ptrs = [p.data_ptr() for leaf in tree_leaves(got) for p in leaf.pieces.flat]
            for b in batches:
                want, want_m = plain(want, b)
                got, got_m = donating(got, b)
            assert [p.data_ptr() for leaf in tree_leaves(got) for p in leaf.pieces.flat] == ptrs
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                assert all(same(p, q) for p, q in zip(a.pieces.flat, b.pieces.flat))
            assert all(same(got_m[k], want_m[k]) for k in want_m)
            if tp:
                continue
            want, got = state, tree_map(lambda t: t.clone(), state)
            ptrs = [t.data_ptr() for t in tree_leaves(got)]
            for b in batches:
                want, want_m = make_train_step(model, opt)(want, b)
                got, got_m = make_train_step(model, opt, donate=True)(got, b)
            assert [t.data_ptr() for t in tree_leaves(got)] == ptrs
            assert all(same(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
            assert all(same(got_m[k], want_m[k]) for k in want_m)

    @staticmethod
    def _zeros(shapes, shardings):
        """Zero pieces of each leaf, made on their devices (a placed moment
        that never exists whole)."""
        if isinstance(shardings, shd.NamedSharding):
            mesh = shardings.mesh
            pieces = np.empty(mesh.devices.shape, dtype=object)
            for idx in np.ndindex(pieces.shape):
                pieces[idx] = torch.zeros(shd.piece_shape(shapes.shape, shardings.spec, mesh),
                                          dtype=shapes.dtype, device=mesh.devices[idx])
            return shd.Placed(pieces, shardings, tuple(shapes.shape), shapes.dtype)
        return {k: TestShardTrain._zeros(shapes[k], shardings[k]) for k in shapes}

    def test_sharded_train_step_across_cards(self):
        """qwen3-8b at full width and depth on a (2, 2) mesh of four distinct
        cards: 16.4 GB of bf16 params and 65.5 GB of f32 AdamW moments, more
        than one card holds. Two donating steps; the first's loss and grad
        norm held to the unsharded forward and backward on card 0 (params
        and gradients fit there, the moments do not); each card's bytes the
        specs' and each card's peak over both steps printed."""
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 4:
            pytest.skip("needs four CUDA devices")
        devices = [torch.device("cuda", k) for k in range(4)]
        self.across_cards(get_arch("qwen3-8b"), devices, 4, 512)

    def across_cards(self, cfg, devices, B, S):
        from repro_torch.core.tree import tree_leaves
        from repro_torch.launch.steps import _value_and_grad, train_state_shapes
        from repro_torch.models.registry import build_model
        from repro_torch.optim import adamw

        dev = devices[0]
        model, opt = build_model(cfg), adamw(1e-3)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        rng = np.random.RandomState(0)
        batches = [{"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, S)),
                                              dtype=torch.int32, device=dev)} for _ in range(2)]
        # the fourth output aliases every param: only the loss and the gradients are kept
        loss_u, grads = _value_and_grad(model, params, batches[0])[::2]
        gnorm_u = float(torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(grads))))
        loss_u = float(loss_u)
        del grads
        mesh = make_mesh((2, 2), ("data", "model"), devices=devices)
        shapes = train_state_shapes(model, opt)
        specs, s_sh, b_sh, steps = self._shardings(cfg, shapes, batches[0], mesh)
        state = {"params": shd.place(params, s_sh["params"]),
                 "opt": self._zeros(shapes["opt"], s_sh["opt"]),
                 "step": shd.place(torch.zeros((), dtype=torch.int32, device=dev), s_sh["step"])}
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        step = steps.make_sharded_train_step(model, opt, s_sh, b_sh, donate=True)
        if dev.type == "cuda":
            for d in devices:
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
        state, met = step(state, batches[0])
        rel = {k: abs(float(met[k]) - want) / abs(want)
               for k, want in (("loss", loss_u), ("grad_norm", gnorm_u))}
        print(f"step 1: loss {float(met['loss'])!r} grad_norm {float(met['grad_norm'])!r}, "
              f"unsharded {loss_u!r} / {gnorm_u!r}, relative {rel}")
        assert all(rel[k] <= self.BF16[k] for k in rel), rel
        state, met = step(state, batches[1])
        assert np.isfinite(float(met["loss"])) and int(shd.gather(state["step"])) == 2
        for leaf in tree_leaves(state):
            for idx in np.ndindex(leaf.pieces.shape):
                assert leaf.pieces[idx].device == mesh.devices[idx]
        want_dev = shd.tree_spec_nbytes(shapes, specs, mesh)
        assert (shd.device_nbytes(state) == want_dev).all()
        if dev.type == "cuda":  # each card holds at least its pieces
            held = [torch.cuda.memory_allocated(d) for d in devices]
            peaks = [torch.cuda.max_memory_allocated(d) for d in devices]
            print(f"step 2: loss {float(met['loss'])!r}; {want_dev} B of pieces a card, the "
                  f"allocator holds {held}; each card's peak over both donating steps {peaks} B")
            assert all(h >= want_dev for h in held)
        return met


class TestTensorParallel:
    """The sharded step's tensor-parallel route on the card (``-k
    tensorparallel``): stablelm and kimi-k2 reduced on (1, 4) and (2, 2)
    meshes of four shards of one card against the unsharded step, and
    qwen3-8b at full width on a (1, 4) mesh of four distinct cards, both
    routes."""

    @pytest.mark.parametrize("dims", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
    @pytest.mark.parametrize("arch", ["stablelm-1.6b", "kimi-k2-1t-a32b"])
    def test_tensorparallel_reduced_step_on_one_card(self, dev, arch, dims):
        self.reduced_step(arch, dims, [dev] * 4)

    @pytest.mark.parametrize("arch", ["stablelm-1.6b", "kimi-k2-1t-a32b"])
    def test_tensorparallel_reduced_step_across_cards(self, arch):
        """The same on a (1, 4) mesh of four distinct cards: each card's
        blocks run in its own autograd thread in the backward, where remat
        recomputes each block once (``layers._RowSum``)."""
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 4:
            pytest.skip("needs four CUDA devices")
        self.reduced_step(arch, (1, 4), [torch.device("cuda", k) for k in range(4)])

    @staticmethod
    def reduced_step(arch, dims, devices):
        """One tensor-parallel step of ``arch`` reduced (f32, remat) on a
        ``dims`` mesh of ``devices`` against the unsharded step on the
        first, under a mesh of that shape on the first (the MoE's branch
        at the same per-shard capacity), within ``TestShardTrain.F32``;
        the span count."""
        from repro_torch import obs
        from repro_torch.core.tree import tree_leaves
        from repro_torch.launch.steps import init_train_state, make_train_step
        from repro_torch.models.registry import build_model
        from repro_torch.optim import adamw

        dev = devices[0]
        cfg = get_arch(arch).reduced().with_(remat=True)
        model, opt = build_model(cfg), adamw(1e-3)
        state = init_train_state(model, opt, torch.Generator(device=dev).manual_seed(0))
        rng = np.random.RandomState(0)
        batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 64)),
                                           dtype=torch.int32, device=dev)}
        mesh = make_mesh(dims, ("data", "model"), devices=devices)
        specs, s_sh, b_sh, steps = TestShardTrain._shardings(cfg, state, batch, mesh)
        with obs.enabled() as tracer:
            new, met = steps.make_sharded_train_step(model, opt, s_sh, b_sh,
                                                     tensor_parallel=True)(state, batch)
        with use_mesh(make_mesh(dims, ("data", "model"), devices=[dev] * len(devices))):
            want, want_m = make_train_step(model, opt)(state, batch)
        tol = TestShardTrain.F32
        for k in want_m:
            rel = abs(float(met[k]) - float(want_m[k])) / max(abs(float(want_m[k])), 1e-30)
            assert rel <= tol["metric"], (k, rel)
        got = shd.gather(new)
        for group, t in (("params", "param"), ("opt", "moment")):
            for a, b in zip(tree_leaves(got[group]), tree_leaves(want[group])):
                assert a.device == dev and a.dtype == b.dtype
                err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                assert err <= tol[t], (group, err)
        assert (shd.device_nbytes(new) == shd.tree_spec_nbytes(state, specs, mesh)).all()
        spans = [e.args for e in tracer.events if e.name == "tensor_parallel"]
        kinds = 1 if cfg.n_experts else 2  # an MoE's experts take their own branch
        assert len(spans) == dims[0] * cfg.n_layers * kinds * 2  # forward + remat's recompute
        assert all(s["mp"] == dims[1] for s in spans)

    # each card's peak over two steps of qwen3-8b on (1, 4) that the
    # donating step must stay under: every card on the tensor-parallel route,
    # cards 1-3 on the gather route (card 0 computes the whole model there);
    # the step without donation peaked at 56.41-56.44 GB on every card (four
    # NVIDIA H100 80GB HBM3 at 700 W)
    DONATED_PEAK = 32e9

    def test_tensor_parallel_step_across_cards(self):
        """qwen3-8b at full width and depth (36 layers, d 4,096, 32 heads,
        8 kv heads, d_ff 12,288, vocab 151,936) on a (1, 4) mesh of four
        distinct cards, two donating steps each route from the same params:
        step 1's loss and grad norm held to the unsharded forward and
        backward on card 0; each card's peak (after step 1's forward and
        backward, and over both steps) and each step's ms printed for both
        routes (step 1 also warms the cards up); the peaks over both steps
        under ``DONATED_PEAK``."""
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 4:
            pytest.skip("needs four CUDA devices")
        import time

        from repro_torch.core.tree import tree_leaves
        from repro_torch.launch import steps
        from repro_torch.launch.steps import _value_and_grad, train_state_shapes
        from repro_torch.models.registry import build_model
        from repro_torch.optim import adamw

        devices = [torch.device("cuda", k) for k in range(4)]
        dev = devices[0]
        cfg = get_arch("qwen3-8b")
        model, opt = build_model(cfg), adamw(1e-3)

        def params():
            return model.init(torch.Generator(device=dev).manual_seed(0), dev)

        rng = np.random.RandomState(0)
        batches = [{"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 512)),
                                              dtype=torch.int32, device=dev)} for _ in range(2)]
        p = params()
        loss_u, grads = _value_and_grad(model, p, batches[0])[::2]
        gnorm_u = float(torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(grads))))
        loss_u = float(loss_u)
        del grads, p
        torch.cuda.empty_cache()
        mesh = make_mesh((1, 4), ("data", "model"), devices=devices)
        shapes = train_state_shapes(model, opt)
        specs, s_sh, b_sh, _ = TestShardTrain._shardings(cfg, shapes, batches[0], mesh)
        want_dev = shd.tree_spec_nbytes(shapes, specs, mesh)
        real_fb, out = steps._forward_backward, {}
        for tp in (False, True):
            p = params()
            state = {"params": shd.place(p, s_sh["params"]),
                     "opt": TestShardTrain._zeros(shapes["opt"], s_sh["opt"]),
                     "step": shd.place(torch.zeros((), dtype=torch.int32, device=dev),
                                       s_sh["step"])}
            del p
            torch.cuda.empty_cache()
            for d in devices:
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
            fb_peaks, ms, mets = [], [], []

            def fb(*a, **kw):
                res = real_fb(*a, **kw)
                fb_peaks.append([torch.cuda.max_memory_allocated(d) for d in devices])
                return res

            step = steps.make_sharded_train_step(model, opt, s_sh, b_sh, tensor_parallel=tp,
                                                 donate=True)
            steps._forward_backward = fb
            try:
                for b in batches:
                    t0 = time.perf_counter()
                    state, met = step(state, b)
                    for d in devices:
                        torch.cuda.synchronize(d)
                    ms.append((time.perf_counter() - t0) * 1e3)
                    mets.append({k: float(v) for k, v in met.items()})
            finally:
                steps._forward_backward = real_fb
            rel = {k: abs(mets[0][k] - want) / abs(want)
                   for k, want in (("loss", loss_u), ("grad_norm", gnorm_u))}
            out[tp] = {"rel": rel, "ms": ms, "fb_peak": fb_peaks[0],
                       "peak": [torch.cuda.max_memory_allocated(d) for d in devices]}
            assert (shd.device_nbytes(state) == want_dev).all()
            assert np.isfinite(mets[1]["loss"]) and int(shd.gather(state["step"])) == 2
            print(f"tensor_parallel={tp}: step 1 loss {mets[0]['loss']!r} grad_norm "
                  f"{mets[0]['grad_norm']!r} (unsharded {loss_u!r} / {gnorm_u!r}, relative "
                  f"{rel}); step 2 loss {mets[1]['loss']!r}; steps {ms} ms; each card's peak "
                  f"after step 1's forward and backward {fb_peaks[0]} B, over both steps "
                  f"{out[tp]['peak']} B; {want_dev} B of pieces a card")
            del state, met
            torch.cuda.empty_cache()
        for tp in (False, True):
            assert all(out[tp]["rel"][k] <= TestShardTrain.BF16[k] for k in out[tp]["rel"]), out
        # the gather route reads every leaf whole onto card 0; blocks stay on their cards
        assert out[True]["fb_peak"][0] < out[False]["fb_peak"][0]
        assert max(out[True]["peak"]) <= self.DONATED_PEAK, out[True]["peak"]
        assert max(out[False]["peak"][1:]) <= self.DONATED_PEAK, out[False]["peak"]


class TestTensorParallelServe:
    """The sharded prefill and decode on the card (``-k tensorparallel``):
    qwen3 reduced with the flash prefill on (1, 4) and (2, 2) meshes of
    four shards of one card against the unsharded steps under the same
    mesh, row 7 on each model shard's heads held against its plain
    version; and qwen3-8b at full width on a (1, 4) mesh of four distinct
    cards."""

    # f32, as tests/test_torch_tensor_parallel_serve.py: each step's logits
    # and the final k/v within 1e-5 of their largest value, pos bit for bit
    RTOL = 1e-5
    # bf16 at full width: max |d log_softmax|, chip_smoke.TP_SERVE_LOGIT_TOL
    LSM_TOL = 0.2

    @staticmethod
    def _run(model, params, batch, toks, mesh, sharded):
        """Prefill, grow by the tokens, one decode step a token (fed
        ``toks``): ([logits], cache), sharded (tensor-parallel) or not
        (under ``use_mesh(mesh)``)."""
        from repro_torch.launch import steps

        B, P = batch["tokens"].shape
        P += batch["patches"].shape[1] if "patches" in batch else 0
        dev = batch["tokens"].device
        step = [{"tokens": toks[:, g:g + 1].contiguous(),
                 "pos": torch.full((B,), P + g, dtype=torch.int32, device=dev)}
                for g in range(toks.shape[1])]
        if not sharded:
            with use_mesh(mesh):
                lg, cache = steps.make_prefill_step(model)(params, batch)
                cache = model.grow_cache(cache, P + toks.shape[1])
                out = [lg]
                for sb in step:
                    lg, cache = steps.make_decode_step(model)(params, cache, sb)
                    out.append(lg)
            return out, cache
        cfg = model.cfg
        p_sh = shd.to_named(shd.tree_param_specs(params, mesh, n_kv_heads=cfg.n_kv_heads), mesh)
        b_sh = shd.to_named(shd.batch_spec(batch, mesh), mesh)
        placed = shd.place(params, p_sh)
        lg, cache = steps.make_sharded_prefill_step(model, p_sh, b_sh, tensor_parallel=True)(
            placed, batch)
        cache = steps.grow_placed_cache(model, cache, P + toks.shape[1])
        c_sh = {k: v.sharding for k, v in cache.items()}
        s_sh = shd.to_named(shd.batch_spec(step[0], mesh), mesh)
        decode = steps.make_sharded_decode_step(model, p_sh, c_sh, s_sh, tensor_parallel=True)
        out = [lg]
        for sb in step:
            lg, cache = decode(placed, cache, sb)
            out.append(lg)
        return out, cache

    @pytest.mark.parametrize("kv", [4, 2], ids=["kv_split", "kv_replicated"])
    @pytest.mark.parametrize("dims", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
    def test_tensorparallel_serve_reduced_on_one_card(self, dev, dims, kv):
        from repro_torch.models.registry import build_model

        cfg = get_arch("qwen3-8b").reduced().with_(use_flash_kernel=True, n_kv_heads=kv)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        rng = np.random.RandomState(0)
        batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 256)),
                                           dtype=torch.int32, device=dev)}
        toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 4)), dtype=torch.int32,
                               device=dev)
        mesh = make_mesh(dims, ("data", "model"), devices=[dev] * 4)
        want, wcache = self._run(model, params, batch, toks, mesh, sharded=False)
        calls, real = [], L.flash_mha

        def flash(q, k, v, *, causal=True):
            out = real(q, k, v, causal=causal)
            calls.append((q, k, v, out))
            return out

        before = kfa.flash_mha.launches
        L.flash_mha = flash
        try:
            got, cache = self._run(model, params, batch, toks, mesh, sharded=True)
        finally:
            L.flash_mha = real
        assert kfa.flash_mha.launches - before == dims[0] * dims[1] * cfg.n_layers == len(calls)
        for q, k, v, out in calls:  # each model shard's heads
            assert q.shape[2] == cfg.n_heads // dims[1] and q.device == dev
            assert kfa.mismatch(out, kfa.flash_attention_plain(q, k, v))["within"]
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= self.RTOL * float(b.abs().max())
        for name in ("k", "v"):
            a, b = shd.gather(cache[name]), wcache[name]
            assert float((a - b).abs().max()) <= self.RTOL * float(b.abs().max()), name
        assert torch.equal(shd.gather(cache["pos"]), wcache["pos"])
        shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in cache.items()}
        assert (shd.device_nbytes(cache) == shd.tree_spec_nbytes(
            shapes, shd.cache_spec(shapes, mesh), mesh)).all()

    def test_tensor_parallel_serve_across_cards(self):
        """qwen3-8b at full width and depth (flash on) on a (1, 4) mesh of
        four distinct cards: a prefill of 4 x 512 tokens and 3 decode steps
        fed the unsharded run's greedy tokens, each step's max |d
        log_softmax| against the unsharded run on card 0; each card's cache
        and param bytes the specs'."""
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 4:
            pytest.skip("needs four CUDA devices")
        import time

        from repro_torch.launch import steps
        from repro_torch.models.registry import build_model

        devices = [torch.device("cuda", k) for k in range(4)]
        dev = devices[0]
        cfg = get_arch("qwen3-8b").with_(use_flash_kernel=True)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        rng = np.random.RandomState(0)
        batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 512)),
                                           dtype=torch.int32, device=dev)}
        # the unsharded greedy run on card 0 gives the tokens the sharded run is fed
        lg, cache = steps.make_prefill_step(model)(params, batch)
        cache = model.grow_cache(cache, 512 + 3)
        want, toks = [torch.log_softmax(lg, -1).cpu()], []
        for g in range(3):
            toks.append(lg.argmax(-1).to(torch.int32)[:, None])
            lg, cache = steps.make_decode_step(model)(params, cache, {
                "tokens": toks[-1], "pos": torch.full((4,), 512 + g, dtype=torch.int32,
                                                      device=dev)})
            want.append(torch.log_softmax(lg, -1).cpu())
        toks = torch.cat(toks, 1)
        del cache
        mesh = make_mesh((1, 4), ("data", "model"), devices=devices)
        p_specs = shd.tree_param_specs(params, mesh, n_kv_heads=cfg.n_kv_heads)
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        got, cache = self._run(model, params, batch, toks, mesh, sharded=True)
        for d in devices:
            torch.cuda.synchronize(d)
        ms = (time.perf_counter() - t0) * 1e3
        gaps = [float((torch.log_softmax(g, -1).cpu() - w).abs().max())
                for g, w in zip(got, want)]
        shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in cache.items()}
        c_want = shd.tree_spec_nbytes(shapes, shd.cache_spec(shapes, mesh), mesh)
        p_want = shd.tree_spec_nbytes(params, p_specs, mesh)
        print(f"qwen3-8b on (1, 4) of four cards: prefill + 3 decode steps {ms:.1f} ms (the "
              f"first call); max |d log_softmax| by step {gaps}; cache {c_want} B and params "
              f"{p_want} B a card by the specs; the allocator holds "
              f"{[torch.cuda.memory_allocated(d) for d in devices]}")
        assert max(gaps) <= self.LSM_TOL, gaps
        assert (shd.device_nbytes(cache) == c_want).all()
        placed = shd.place(params, shd.to_named(p_specs, mesh))
        assert (shd.device_nbytes(placed) == p_want).all()
        for leaf in cache.values():
            for idx in np.ndindex(leaf.pieces.shape):
                assert leaf.pieces[idx].device == mesh.devices[idx]


class TestTensorParallelFamilies:
    """The ssm, hybrid and audio families on the tensor-parallel route on
    the card (``-k TestTensorParallelFamilies``): falcon-mamba, zamba2 and
    whisper reduced (f32, flash on) on (1, 4) and (2, 2) meshes of four
    shards of one card, one train step against the unsharded step
    (``TestShardTrain.F32``) and the prefill and 4 decode steps against the
    unsharded steps (``TestTensorParallelServe.RTOL``), row 7 on each model
    shard's heads held against its plain version; and falcon-mamba-7b at
    full width and depth on a (1, 4) mesh of four distinct cards."""

    # reduced() overrides: zamba2 as 2 segments of 2 Mamba-2 layers
    ARCHS = {"falcon-mamba-7b": {}, "zamba2-2.7b": {"n_layers": 4, "attn_every": 2},
             "whisper-tiny": {}}
    # bf16 at full width: max |d log_softmax|, chip_smoke.TP_FAM_SERVE_LOGIT_TOL
    LSM_TOL = 1.0

    @staticmethod
    def _batch(cfg, rng, dev, S):
        batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, S)),
                                           dtype=torch.int32, device=dev)}
        if cfg.family == "audio":
            batch["frames"] = torch.as_tensor(
                rng.randn(4, cfg.encoder_seq, cfg.frontend_dim).astype(np.float32), device=dev)
        return batch

    @pytest.mark.parametrize("dims", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
    @pytest.mark.parametrize("arch", list(ARCHS))
    def test_tensorparallel_families_on_one_card(self, dev, arch, dims):
        from repro_torch import obs
        from repro_torch.core.tree import tree_leaves
        from repro_torch.launch.steps import init_train_state, make_train_step
        from repro_torch.models.registry import build_model
        from repro_torch.optim import adamw

        cfg = get_arch(arch).reduced().with_(use_flash_kernel=True, **self.ARCHS[arch])
        model, opt = build_model(cfg), adamw(1e-3)
        mesh = make_mesh(dims, ("data", "model"), devices=[dev] * 4)
        rng = np.random.RandomState(0)
        # one train step
        state = init_train_state(model, opt, torch.Generator(device=dev).manual_seed(0))
        batch = self._batch(cfg, rng, dev, 64)
        specs, s_sh, b_sh, steps = TestShardTrain._shardings(cfg, state, batch, mesh)
        with obs.enabled() as tracer:
            new, met = steps.make_sharded_train_step(model, opt, s_sh, b_sh,
                                                     tensor_parallel=True)(state, batch)
        with use_mesh(mesh):
            want, want_m = make_train_step(model, opt)(state, batch)
        tol = TestShardTrain.F32
        for k in want_m:
            rel = abs(float(met[k]) - float(want_m[k])) / max(abs(float(want_m[k])), 1e-30)
            assert rel <= tol["metric"], (k, rel)
        got = shd.gather(new)
        for group, t in (("params", "param"), ("opt", "moment")):
            for a, b in zip(tree_leaves(got[group]), tree_leaves(want[group])):
                err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                assert err <= tol[t], (group, err)
        assert (shd.device_nbytes(new) == shd.tree_spec_nbytes(state, specs, mesh)).all()
        kinds = {e.args["kind"] for e in tracer.events if e.name == "tensor_parallel"}
        assert kinds == {"ssm": {"mamba1"}, "hybrid": {"mamba2", "attn", "mlp"},
                         "audio": {"attn", "cross_attn", "mlp"}}[cfg.family]
        del new, got, want, state
        # the prefill and 4 decode steps, row 7 on each model shard's heads
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        batch = self._batch(cfg, rng, dev, 128)
        toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 4)), dtype=torch.int32,
                               device=dev)
        run = TestTensorParallelServe._run
        want, wcache = run(model, params, batch, toks, mesh, sharded=False)
        calls, real = [], L.flash_mha

        def flash(q, k, v, *, causal=True):
            out = real(q, k, v, causal=causal)
            calls.append((q, k, v, out))
            return out

        before = kfa.flash_mha.launches
        L.flash_mha = flash
        try:
            got, cache = run(model, params, batch, toks, mesh, sharded=True)
        finally:
            L.flash_mha = real
        # one causal attention a layer: none for ssm, one a segment for hybrid
        attn = cfg.n_layers // (cfg.attn_every or 1) if cfg.family != "ssm" else 0
        assert kfa.flash_mha.launches - before == 4 * attn == len(calls)
        for q, k, v, out in calls:
            assert q.shape[2] == cfg.n_heads // dims[1]
            assert kfa.mismatch(out, kfa.flash_attention_plain(q, k, v))["within"]
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= TestTensorParallelServe.RTOL * float(
                b.abs().max())
        for name, leaf in cache.items():
            a, b = shd.gather(leaf), wcache[name]
            assert float((a.float() - b.float()).abs().max()) <= (
                TestTensorParallelServe.RTOL * float(b.float().abs().max())), name
        shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in cache.items()}
        assert (shd.device_nbytes(cache) == shd.tree_spec_nbytes(
            shapes, shd.cache_spec(shapes, mesh), mesh)).all()

    def test_tensor_parallel_falcon_mamba_across_cards(self):
        """falcon-mamba-7b at full width and depth on a (1, 4) mesh of four
        distinct cards: a prefill of 4 x 512 tokens and 3 decode steps fed
        the unsharded run's greedy tokens, each step's max |d log_softmax|
        against the unsharded run on card 0 within ``LSM_TOL``; each card
        holds a quarter of the Mamba blocks and the vocab (the specs'
        bytes, under 0.3 of the params), and its cache pieces."""
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 4:
            pytest.skip("needs four CUDA devices")
        import time

        from repro_torch.core.tree import tree_leaves
        from repro_torch.launch import steps
        from repro_torch.models.registry import build_model

        devices = [torch.device("cuda", k) for k in range(4)]
        dev = devices[0]
        cfg = get_arch("falcon-mamba-7b")
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        total = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        rng = np.random.RandomState(0)
        batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 512)),
                                           dtype=torch.int32, device=dev)}
        lg, cache = steps.make_prefill_step(model)(params, batch)
        want, toks = [torch.log_softmax(lg, -1).cpu()], []
        for g in range(3):
            toks.append(lg.argmax(-1).to(torch.int32)[:, None])
            lg, cache = steps.make_decode_step(model)(params, cache, {
                "tokens": toks[-1], "pos": torch.full((4,), 512 + g, dtype=torch.int32,
                                                      device=dev)})
            want.append(torch.log_softmax(lg, -1).cpu())
        toks = torch.cat(toks, 1)
        del cache
        mesh = make_mesh((1, 4), ("data", "model"), devices=devices)
        p_specs = shd.tree_param_specs(params, mesh, n_kv_heads=cfg.n_kv_heads)
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        got, cache = TestTensorParallelServe._run(model, params, batch, toks, mesh, sharded=True)
        for d in devices:
            torch.cuda.synchronize(d)
        ms = (time.perf_counter() - t0) * 1e3
        gaps = [float((torch.log_softmax(g, -1).cpu() - w).abs().max())
                for g, w in zip(got, want)]
        shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in cache.items()}
        c_want = shd.tree_spec_nbytes(shapes, shd.cache_spec(shapes, mesh), mesh)
        p_want = shd.tree_spec_nbytes(params, p_specs, mesh)
        print(f"falcon-mamba-7b on (1, 4) of four cards: prefill + 3 decode steps {ms:.1f} ms "
              f"(the first call); max |d log_softmax| by step {gaps}; params {p_want} B of "
              f"{total} B and cache {c_want} B a card by the specs; the allocator holds "
              f"{[torch.cuda.memory_allocated(d) for d in devices]}")
        assert max(gaps) <= self.LSM_TOL, gaps
        assert p_want <= 0.3 * total
        assert (shd.device_nbytes(cache) == c_want).all()
        placed = shd.place(params, shd.to_named(p_specs, mesh))
        assert (shd.device_nbytes(placed) == p_want).all()
        for leaf in cache.values():
            for idx in np.ndindex(leaf.pieces.shape):
                assert leaf.pieces[idx].device == mesh.devices[idx]
