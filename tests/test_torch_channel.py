"""Parity of the port's physical channel (``core/channel.py``), its config
fields and its draws with the JAX reference, on the CPU.

The truncated inversion is elementwise f32 arithmetic, so the gains, the
transmit amplitudes and the truncation set must be exact for the same
|h|; the reference's own fading draws are handed to the port through the
round-draws seam (``JaxDraws.fading_habs``). Float sums (the weight
normaliser) and transcendental functions (log10, sqrt) are compared
within a stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.core import channel as jchan
from repro_torch.configs import FLConfig as TFLConfig
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import channel as tchan
from repro_torch.core import ota as tota
from repro_torch.fl.server import FLServer as TFLServer
from test_torch_fl import JaxDraws

CONFIGS = [
    dict(),
    dict(fade_threshold=0.3, power_budget=4.0),
    dict(fade_threshold=0.05, rho=2.0, power_budget=16.0, pathloss_spread_db=6.0),
]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _exact(got, want):
    np.testing.assert_array_equal(
        np.asarray(got, np.float32).view(np.uint32), np.asarray(want, np.float32).view(np.uint32)
    )


def _habs(seed, n=64):
    rng = np.random.RandomState(seed)
    h = np.sqrt(0.5 * (rng.randn(n) ** 2 + rng.randn(n) ** 2)).astype(np.float32)
    # boundary cases: |h|^2 exactly at the 0.25 threshold, the inversion
    # point rho / |h| == sqrt(P) for P = 16 and 4, a zero channel
    h[:5] = [0.5, 0.25, 0.5, 0.0, 0.49999]
    return h


@pytest.mark.parametrize("kw", CONFIGS + [dict(fade_threshold=0.25, power_budget=16.0),
                                          dict(fade_threshold=0.25, power_budget=4.0)])
def test_state_from_habs_exact(kw):
    h = _habs(len(kw))
    jc, tc = jchan.ChannelConfig(**kw), tchan.ChannelConfig(**kw)
    js = jchan.state_from_habs(jnp.asarray(h), cfg=jc)
    ts = tchan.state_from_habs(_t(h), cfg=tc)
    _exact(ts.habs, js.habs)
    _exact(ts.gains, js.gains)
    _exact(ts.tx_amp, js.tx_amp)
    np.testing.assert_array_equal(ts.truncated.numpy(), np.asarray(js.truncated))
    assert ts.n_truncated == js.n_truncated
    _exact(ts.misalignment, js.misalignment)


def test_state_from_habs_boundaries():
    """|h|^2 == threshold participates; at the inversion point the cap binds
    with gain exactly 1; past it the client is misaligned."""
    ts = tchan.state_from_habs(_t([0.5, 0.49999, 0.25, 0.125]),
                               cfg=tchan.ChannelConfig(fade_threshold=1e-4, power_budget=16.0))
    g, tx = ts.gains.numpy(), ts.tx_amp.numpy()
    assert g[0] > 0 and g[1] > 0
    assert tx[2] == 4.0 and g[2] == 1.0
    assert tx[3] == 4.0 and 0.0 < g[3] < 1.0 and ts.misalignment[3] > 0
    ts = tchan.state_from_habs(_t([0.5, 0.49999]), cfg=tchan.ChannelConfig(fade_threshold=0.25))
    assert ts.gains[0] > 0 and ts.gains[1] == 0


@pytest.mark.parametrize("kw", CONFIGS)
def test_snr_and_uncontrolled_gains_close(kw):
    """log10 and sqrt are not correctly rounded in either library: rtol
    1e-6 (a few f32 ulps)."""
    h = _habs(7)
    js = jchan.state_from_habs(jnp.asarray(h), cfg=jchan.ChannelConfig(**kw))
    ts = tchan.state_from_habs(_t(h), cfg=tchan.ChannelConfig(**kw))
    np.testing.assert_allclose(ts.snr_db(20.0).numpy(), np.asarray(js.snr_db(20.0)), rtol=1e-6)
    jm, tm = jchan.ChannelModel(jchan.ChannelConfig(**kw)), tchan.ChannelModel(
        tchan.ChannelConfig(**kw))
    np.testing.assert_allclose(tm.uncontrolled_gains(ts).numpy(),
                               np.asarray(jm.uncontrolled_gains(js)), rtol=1e-6)


def test_combine_weights_and_all_truncated():
    """The survivors' weights sum K floats in another order than XLA:
    rtol 1e-6. Truncated rows get exact zeros; an all-truncated cohort
    gives all zeros, no NaN."""
    rng = np.random.RandomState(3)
    w = rng.rand(9).astype(np.float32) * 40
    g = rng.rand(9).astype(np.float32)
    g[[1, 4, 5]] = 0.0
    want = np.asarray(jchan.combine_weights(jnp.asarray(w), jnp.asarray(g)))
    got = tchan.combine_weights(_t(w), _t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.all(got[[1, 4, 5]] == 0.0)
    zeros = tchan.combine_weights(_t(w), torch.zeros(9)).numpy()
    np.testing.assert_array_equal(zeros, np.zeros(9, np.float32))
    assert not np.isnan(zeros).any()
    ts = tchan.state_from_habs(_t(_habs(1)), cfg=tchan.ChannelConfig())
    model = tchan.ChannelModel()
    assert torch.equal(model.combine_weights(_t(w[:1]).repeat(64), ts),
                       tchan.combine_weights(_t(w[:1]).repeat(64), ts.gains))


def test_split_survivors_exact():
    h = _habs(11)
    js = jchan.state_from_habs(jnp.asarray(h), cfg=jchan.ChannelConfig(fade_threshold=0.25))
    ts = tchan.state_from_habs(_t(h), cfg=tchan.ChannelConfig(fade_threshold=0.25))
    (jk, jd), (tk, td) = jchan.split_survivors(js), tchan.split_survivors(ts)
    assert tk.tolist() == np.asarray(jk).tolist() and td.tolist() == np.asarray(jd).tolist()
    assert len(td) > 0 and len(tk) > 0


@pytest.mark.parametrize("seed", [0, 5, 131])
@pytest.mark.parametrize("kw", CONFIGS)
def test_channel_model_sample_with_reference_draws_exact(seed, kw):
    js = jchan.ChannelModel(jchan.ChannelConfig(**kw)).sample(jax.random.key(seed), 20)
    ts = tchan.ChannelModel(tchan.ChannelConfig(**kw)).sample(JaxDraws(seed), 20)
    _exact(ts.habs, js.habs)
    _exact(ts.gains, js.gains)
    _exact(ts.tx_amp, js.tx_amp)


def test_torch_draws_fading_stream_is_separate():
    """Drawing the fading channel leaves the dither seeds, the coin-flip and
    the AWGN draws unchanged, whatever the order; every stream is a pure
    function of the round seed."""
    a, b = tota.TorchRoundDraws(42, "cpu"), tota.TorchRoundDraws(42, "cpu")
    ha, pa = a.channel(8, 0.1)
    na = a.awgn(100)
    fb = b.fading_habs(8, 0.0)
    nb = b.awgn(100)
    hb, pb = b.channel(8, 0.1)
    assert (a.sr_seed, a.dl_seed) == (b.sr_seed, b.dl_seed)
    assert torch.equal(ha, hb) and torch.equal(pa, pb) and torch.equal(na, nb)
    assert torch.equal(fb, a.fading_habs(8, 0.0))
    assert not torch.equal(fb, ha)
    assert not torch.equal(tota.TorchRoundDraws(43, "cpu").fading_habs(8, 0.0), fb)
    shadowed = b.fading_habs(8, 6.0)
    assert shadowed.shape == (8,) and not torch.equal(shadowed, fb)
    assert (fb > 0).all()


def test_fl_config_channel_fields_match_reference():
    j, t = JFLConfig(), TFLConfig()
    for f in ("channel_model", "fade_threshold", "tx_power_budget", "pathloss_spread_db"):
        assert getattr(t, f) == getattr(j, f), f


def test_unknown_channel_model_raises():
    with pytest.raises(ValueError, match="unknown channel_model"):
        TFLServer(TFLConfig(n_clients=2, clients_per_round=2, channel_model="rician"),
                  tget_arch("deepspeech2").with_(n_layers=1, d_model=32), device="cpu",
                  shard_size=4)


def test_client_echoes_channel_state():
    srv = TFLServer(TFLConfig(n_clients=2, clients_per_round=2),
                    tget_arch("deepspeech2").with_(n_layers=1, d_model=32), device="cpu",
                    shard_size=4)
    _, m = srv.clients[0].local_update(srv.params, 8, local_steps=1, local_batch=2,
                                       layout=srv.layout, sr_seed=7,
                                       channel_gain=0.8125, channel_habs=1.5)
    assert m["channel_gain"] == 0.8125 and m["channel_habs"] == 1.5
