"""Parity of the port's streaming round (``plan_stream``,
``staleness_weights``, ``OtaAccumulator``, ``StreamingFLServer``) with the
JAX reference, on the CPU, at a small size (1 GRU layer of 32, 6 clients),
on the ideal and the fading channel.

Both packages start from the same weights, and the port's round-draws seam
is fed the reference's own draws for each round key, so the bits plan, the
arrival plan (on-time / late / lost), the truncation set and the byte
counts must agree exactly, and the params within the stated tolerance.
Inside the port the reference's own identities hold exactly: a single
wave is the barrier aggregate, and the no-deadline streaming server is
``FLServer`` bit for bit.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.base import get_arch as jget_arch
from repro.core import ota as jota
from repro.core import packing as jpacking
from repro.core import wire as jwire
from repro.fl import StreamingFLServer as JStreamingFLServer
from repro.fl.client import LatencyModel as JLatencyModel
from repro.fl.server import plan_stream as jplan_stream
from repro_torch import convert
from repro_torch.configs import FLConfig as TFLConfig
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import channel as tchan
from repro_torch.core import ota as tota
from repro_torch.core import packing as tpacking
from repro_torch.core import wire as twire
from repro_torch.fl import FLServer as TFLServer
from repro_torch.fl import LatencyModel as TLatencyModel
from repro_torch.fl import StreamingFLServer as TStreamingFLServer
from repro_torch.fl import plan_stream as tplan_stream
from test_torch_fl import JaxDraws

ROUNDS = 2
CFG = dict(n_clients=6, clients_per_round=6, local_steps=1, local_batch=2, lr=2e-3, seed=0,
           quant_block=256, fade_threshold=0.3)
ARCH = dict(n_layers=1, d_model=32)
# fill half the cohort, then a 0.3 s grace window: at this size and seed
# every round has an on-time and a late wave, and lost rows on the ideal
# channel
STREAM = dict(fill_fraction=0.5, grace_s=0.3)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _fields(plan):
    return dataclasses.astuple(plan)


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(tree)])


# ---------------------------------------------------------------- plan_stream


def _arrivals(seed, n=12, n_inf=2):
    rng = np.random.RandomState(seed)
    t = list(rng.lognormal(0.0, 1.0, size=n))
    for j in rng.choice(n, n_inf, replace=False):
        t[j] = math.inf
    return t


@pytest.mark.parametrize("case", [
    dict(fill=12),  # unreachable fill (two never arrive), no deadline: the barrier
    dict(fill=6, grace=0.7),
    dict(fill=6, deadline=0.4, grace=1.0, gamma=0.3),
    dict(fill=3, deadline=5.0, grace=0.0),
    dict(fill=0, grace=2.0),
    dict(fill=10, deadline=0.01, grace=0.05),  # deadline before any arrival
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_stream_exact(seed, case):
    times = _arrivals(seed)
    assert _fields(tplan_stream(times, **case)) == _fields(jplan_stream(times, **case))


def test_plan_stream_grace_and_trigger_boundaries():
    """An arrival exactly at the trigger is on time, one exactly at the end
    of the grace window is late (discount gamma), later ones are lost."""
    times = [1.0, 2.0, 3.0, 3.5]
    t, j = tplan_stream(times, fill=2, grace=1.0), jplan_stream(times, fill=2, grace=1.0)
    assert _fields(t) == _fields(j)
    assert (t.on_time, t.late, t.lost, t.staleness) == ((0, 1), (2,), (3,), (0.5,))


def test_plan_stream_all_lost_and_empty():
    times = [math.inf] * 5
    assert _fields(tplan_stream(times, fill=3, grace=1.0)) == _fields(
        jplan_stream(times, fill=3, grace=1.0))
    p = tplan_stream(times, fill=3)
    assert p.counted == () and p.lost == tuple(range(5))
    assert _fields(tplan_stream([], fill=1)) == _fields(jplan_stream([], fill=1))


@pytest.mark.parametrize("gamma", [0.5, 0.2, 1.0])
def test_staleness_weights_close(gamma):
    """pow is not correctly rounded in either library: rtol 1e-6."""
    delays = np.array([0.0, 0.01, 0.3, 0.99, 1.0, 2.5, 40.0], np.float32)
    want = np.asarray(jota.staleness_weights(jnp.asarray(delays), 1.0, gamma=gamma))
    got = tota.staleness_weights(_t(delays), 1.0, gamma=gamma).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.min() >= min(gamma, 1.0) and got.max() <= 1.0


# ---------------------------------------------------------------- accumulator


M = 4096 + 600


def _cohort(bits, seed=0, block=256):
    rng = np.random.RandomState(seed)
    rows_j, rows_t = [], []
    for i, b in enumerate(bits):
        row = (rng.randn(M) * 0.01).astype(np.float32)
        rows_j.append(jwire.encode_row(jnp.asarray(row), b, jnp.uint32(0x5EED), i, block=block))
        rows_t.append(twire.encode_row(_t(row), b, 0x5EED, i, block=block))
    return rows_j, rows_t


def test_single_wave_fold_is_the_barrier_aggregate():
    """fold(zeros state, b) with the round's weights == the pre-noise
    aggregate of ``ota_aggregate_packed``, exactly, with and without gains."""
    bits = [4, 8, 16, 32, 8, 4, 24]
    _, rows = _cohort(bits)
    layout = tpacking.make_layout({"w": torch.zeros(M)})
    weights = torch.rand(len(bits), generator=torch.Generator().manual_seed(0)) + 0.1
    draws = tota.TorchRoundDraws(3, "cpu")
    tota.ota_aggregate_packed(draws, rows, bits, weights, layout)
    _, _, w = tota.round_channel(draws, weights, cfg=tota.OTAConfig())
    acc = tota.OtaAccumulator(layout).fold(rows, w)
    assert torch.equal(acc.accumulator, tota.ota_aggregate_packed.last_acc)
    gains = torch.tensor([0.9, 0.0, 1.0, 0.5, 0.7, 0.0, 0.25])
    tota.ota_aggregate_packed(draws, rows, bits, weights, layout, gains=gains)
    acc = tota.OtaAccumulator(layout).fold(rows, tchan.combine_weights(weights, gains),
                                            gains=gains)
    assert torch.equal(acc.accumulator, tota.ota_aggregate_packed.last_acc)
    assert acc.n_folded == len(bits) and acc.wire_bytes == twire.wire_bytes(rows)


def test_all_truncated_wave_leaves_state_unchanged():
    _, rows = _cohort([8, 16, 4, 8], seed=1)
    layout = tpacking.make_layout({"w": torch.zeros(M)})
    acc = tota.OtaAccumulator(layout)
    assert torch.equal(acc.accumulator, torch.zeros(layout.padded_size))
    acc.fold(rows[:2], torch.tensor([0.4, 0.6]))
    before = acc.accumulator.clone()
    acc.fold(rows[2:], torch.tensor([0.5, 0.5]), gains=torch.zeros(2))
    assert torch.equal(acc.accumulator, before)
    acc.reset()
    assert acc.n_folded == 0 and torch.equal(acc.accumulator, torch.zeros(layout.padded_size))


def test_two_wave_fold_and_finalize_match_reference():
    """Two waves (the second with staleness and gains) against the
    reference accumulator (its jitted oracles): the state within rtol 1e-4
    (the K-sum is reassociated), the bytes and counts exact."""
    bits = [4, 8, 16, 32, 8, 16]
    rows_j, rows_t = _cohort(bits, seed=2)
    layout_j = jpacking.make_layout({"w": jnp.zeros((M,), jnp.float32)})
    layout_t = tpacking.make_layout({"w": torch.zeros(M)})
    w = np.random.RandomState(4).rand(6).astype(np.float32)
    stale = [0.8, 0.6]
    g = np.array([0.9, 0.7], np.float32)
    accj = jota.OtaAccumulator(layout_j, use_kernel=False)
    accj.fold(rows_j[:4], jnp.asarray(w[:4]))
    accj.fold(rows_j[4:], jnp.asarray(w[4:]), staleness=stale, gains=jnp.asarray(g))
    acct = tota.OtaAccumulator(layout_t)
    acct.fold(rows_t[:4], _t(w[:4]))
    acct.fold(rows_t[4:], _t(w[4:]), staleness=stale, gains=_t(g))
    want = np.asarray(accj.accumulator)
    np.testing.assert_allclose(acct.accumulator.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())
    key = jax.random.key(5)
    agg_j, info_j = accj.finalize(key)
    agg_t, info_t = acct.finalize(JaxDraws(5))
    assert (info_t["n_folded"], info_t["uplink_bytes"], info_t["uplink_bytes_f32"]) == (
        info_j["n_folded"], info_j["uplink_bytes"], info_j["uplink_bytes_f32"])
    np.testing.assert_allclose(info_t["noise_std"], info_j["noise_std"], rtol=1e-4)
    np.testing.assert_allclose(agg_t["w"].numpy(), np.asarray(agg_j["w"]), rtol=1e-4,
                               atol=1e-6 * np.abs(np.asarray(agg_j["w"])).max())


# ---------------------------------------------------------------- servers


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


@pytest.fixture(scope="module", params=["ideal", "fading"])
def stream_rounds(request):
    """Two streaming rounds in each package from the same weights and draws."""
    cfg = dict(CFG, channel_model=request.param)
    js = JStreamingFLServer(JFLConfig(**cfg), jget_arch("deepspeech2").with_(**ARCH),
                            shard_size=8, latency=JLatencyModel.with_tail(5.0), **STREAM)
    p0 = _np(js.params)
    ts = TStreamingFLServer(TFLConfig(**cfg), tget_arch("deepspeech2").with_(**ARCH),
                            device="cpu", shard_size=8,
                            init_params=convert.params_from_numpy(p0, "cpu"), draws=JaxDraws,
                            latency=TLatencyModel.with_tail(5.0), **STREAM)
    out = dict(js=js, ts=ts, p0=p0, jlogs=[], tlogs=[], jplans=[], tplans=[], jparams=[],
               tparams=[], jfleet=[], tfleet=[], tparts=[])
    for r in range(ROUNDS):
        out["jlogs"].append(js.run_round(r))
        out["jplans"].append(js.last_plan)
        out["jparams"].append(_np(js.params))
        out["jfleet"].append([(s.channel_snr_db, s.truncation_rate) for s in js.fleet])
        out["tlogs"].append(ts.run_round(r))
        out["tplans"].append(ts.last_plan)
        out["tparams"].append(convert.params_to_numpy(ts.params))
        out["tfleet"].append([(s.channel_snr_db, s.truncation_rate) for s in ts.fleet])
    out["channel"] = request.param
    return out


def test_stream_plan_bits_bytes_exact(stream_rounds):
    n_late = 0
    for jl, tl, jp, tp in zip(stream_rounds["jlogs"], stream_rounds["tlogs"],
                              stream_rounds["jplans"], stream_rounds["tplans"]):
        assert tl.bits == jl.bits
        assert _fields(tp) == _fields(jp)
        assert (tl.n_on_time, tl.n_late, tl.n_lost) == (jl.n_on_time, jl.n_late, jl.n_lost)
        assert tl.n_participating == jl.n_participating
        assert (tl.uplink_bytes, tl.downlink_bytes) == (jl.uplink_bytes, jl.downlink_bytes)
        assert tl.sim_seconds == jl.sim_seconds
        n_late += tl.n_late
    assert n_late > 0  # the late wave is exercised


def test_stream_channel_features_match(stream_rounds):
    """Truncation rates exact; the SNR feature (a log10) within rtol 1e-6."""
    for jf, tf in zip(stream_rounds["jfleet"], stream_rounds["tfleet"]):
        for (jsnr, jtr), (tsnr, ttr) in zip(jf, tf):
            assert ttr == jtr
            assert (tsnr is None) == (jsnr is None)
            if tsnr is not None:
                np.testing.assert_allclose(tsnr, jsnr, rtol=1e-6)
    if stream_rounds["channel"] == "fading":
        assert any(tr > 0 for _, tr in stream_rounds["tfleet"][-1])  # truncation happened


def test_stream_params_close(stream_rounds):
    """||dp_port - dp_jax|| <= 1e-2 ||dp_jax|| after each round (local
    training and the K-sum are reassociated)."""
    p0 = _flat(stream_rounds["p0"])
    for jp, tp in zip(stream_rounds["jparams"], stream_rounds["tparams"]):
        dj, dt = _flat(jp) - p0, _flat(tp) - p0
        assert np.linalg.norm(dj) > 0
        assert np.linalg.norm(dt - dj) <= 1e-2 * np.linalg.norm(dj)


def test_stream_waves_refold_with_plain_versions(stream_rounds):
    """The last round's waves re-folded with the plain versions equal the
    accumulator exactly (on the CPU the wrappers are the plain versions;
    on the card ``chip_smoke.py`` makes the same check against the
    kernels)."""
    last = stream_rounds["ts"].last_round
    acc = None
    for wave in last["waves"]:
        w = wave["weights"]
        if wave["staleness"] is not None:
            w = w * torch.tensor(wave["staleness"], dtype=torch.float32)
        acc = tota.aggregate_plain(wave["rows"], w, wave["gains"], acc=acc)
    assert len(last["waves"]) == 2
    assert torch.equal(acc, last["acc"])


@pytest.mark.parametrize("channel", ["ideal", "fading"])
def test_no_deadline_stream_equals_barrier_bitwise(channel):
    cfg = TFLConfig(**dict(CFG, channel_model=channel, seed=2))
    arch = tget_arch("deepspeech2").with_(**ARCH)
    bar = TFLServer(cfg, arch, device="cpu", shard_size=8)
    stream = TStreamingFLServer(cfg, arch, device="cpu", shard_size=8)
    for r in range(ROUNDS):
        lb = bar.run_round(r)
        barrier_acc = tota.ota_aggregate_packed.last_acc
        ls = stream.run_round(r)
        assert (lb.bits, lb.n_participating, lb.uplink_bytes) == (
            ls.bits, ls.n_participating, ls.uplink_bytes)
        assert ls.n_late == 0 and ls.n_lost == 0
        assert torch.equal(stream.last_round["acc"], barrier_acc)
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(bar.params)),
                    jax.tree.leaves(convert.params_to_numpy(stream.params))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("entry", ["stream", "cli"])
def test_entry_points_without_device_raise_on_a_cardless_machine(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from repro_torch.fl import __main__ as cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "stream":
            TStreamingFLServer(TFLConfig(n_clients=2, clients_per_round=2),
                               tget_arch("deepspeech2").with_(**ARCH))
        else:
            cli.main(["--rounds", "1", "--clients", "2", "--per-round", "2",
                      "--channel", "fading"])
