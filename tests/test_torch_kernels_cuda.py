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
from repro_torch.fl.server import FLServer
from repro_torch.kernels import ota_fused as kota
from repro_torch.kernels import topk_similarity as ktk
from repro_torch.retrieval.arena import ArenaStore

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
