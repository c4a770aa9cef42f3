"""Parity of the PyTorch port's federated round with the JAX reference, on
the CPU, at a small size (1-2 GRU layers of 32, 6 clients).

Both packages start from the same weights (the reference's, through
``repro_torch.convert``) and the port's round-draws seam is fed the
reference's own ``jax.random`` draws for each round key, so the bits plan,
the byte counts and the participation must agree exactly, and the float
results (logits, losses, params) within the stated tolerances.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.channel as jchan
import repro.core.ota as jota
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.base import get_arch as jget_arch
from repro.fl import FLServer as JFLServer
from repro.models import deepspeech2 as jds2
from repro_torch import convert
from repro_torch.configs import FLConfig as TFLConfig
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import ota as tota
from repro_torch.core import packing as tpacking
from repro_torch.fl.server import FLServer as TFLServer
from repro_torch.models import deepspeech2 as tds2

ROOT = pathlib.Path(__file__).resolve().parent.parent
ROUNDS = 2
CFG = dict(n_clients=6, clients_per_round=6, local_steps=2, local_batch=2, lr=2e-3,
           seed=0, quant_block=256)
ARCH = dict(n_layers=1, d_model=32)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


class JaxDraws(tota.RoundDraws):
    """The reference's round-key draws, handed to the port."""

    def __init__(self, seed, device="cpu"):
        self.key = jax.random.key(seed)
        self.sr_seed = int(jota.derive_sr_seed(self.key))
        self.dl_seed = int(jota.derive_dl_seed(self.key))

    def channel(self, k, fade_threshold):
        h, p = jota.sample_channel(jax.random.split(self.key, 3)[0], k, fade_threshold)
        return torch.from_numpy(np.array(h)), torch.from_numpy(np.array(p))

    def fading_habs(self, n, pathloss_spread_db):
        cfg = jchan.ChannelConfig(pathloss_spread_db=pathloss_spread_db)
        return torch.from_numpy(np.array(jchan._sample_habs(self.key, n_clients=n, cfg=cfg)))

    def awgn(self, n):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.split(self.key, 3)[2], (n,))))


@pytest.fixture(scope="module")
def rounds():
    """Two rounds in each package from the same weights and draws."""
    jarch = jget_arch("deepspeech2").with_(**ARCH)
    tarch = tget_arch("deepspeech2").with_(**ARCH)
    js = JFLServer(JFLConfig(**CFG), jarch, shard_size=8)
    p0 = _np(js.params)
    ts = TFLServer(TFLConfig(**CFG), tarch, device="cpu", shard_size=8,
                   init_params=convert.params_from_numpy(p0, "cpu"), draws=JaxDraws)
    captured = []
    orig = jota.ota_aggregate_packed

    def capture(key, X, bits, weights, layout, cfg=jota.OTAConfig(), **kw):
        agg, info = orig(key, X, bits, weights, layout, cfg, **kw)
        captured.append(dict(key=key, rows=list(X), bits=list(bits),
                             weights=np.asarray(weights), agg=_np(agg), info=info))
        return agg, info

    jota.ota_aggregate_packed = capture
    try:
        jlogs, jparams = [], []
        for r in range(ROUNDS):
            jlogs.append(js.run_round(r))
            jparams.append(_np(js.params))
    finally:
        jota.ota_aggregate_packed = orig
    tlogs, tparams = [], []
    for r in range(ROUNDS):
        tlogs.append(ts.run_round(r))
        tparams.append(convert.params_to_numpy(ts.params))
    return dict(js=js, ts=ts, p0=p0, jlogs=jlogs, tlogs=tlogs, jparams=jparams,
                tparams=tparams, captured=captured, jarch=jarch, tarch=tarch)


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(tree)])


# ---------------------------------------------------------------- exact


def test_round_bits_bytes_participation_exact(rounds):
    for jl, tl in zip(rounds["jlogs"], rounds["tlogs"]):
        assert tl.bits == jl.bits
        assert tl.uplink_bytes == jl.uplink_bytes
        assert tl.downlink_bytes == jl.downlink_bytes
        assert tl.n_participating == jl.n_participating


def test_layout_matches_reference(rounds):
    lj, lt = rounds["js"].layout, rounds["ts"].layout
    assert (lt.shapes, lt.offsets, lt.size, lt.padded_size) == (
        lj.shapes, lj.offsets, lj.size, lj.padded_size)


# ---------------------------------------------------------------- tolerance


def test_round_train_loss_close(rounds):
    for jl, tl in zip(rounds["jlogs"], rounds["tlogs"]):
        np.testing.assert_allclose(tl.train_loss, jl.train_loss, rtol=1e-3)


def test_round_param_change_close(rounds):
    """||dp_port - dp_jax|| <= 1e-2 ||dp_jax|| after each round."""
    p0 = _flat(rounds["p0"])
    for jp, tp in zip(rounds["jparams"], rounds["tparams"]):
        dj, dt = _flat(jp) - p0, _flat(tp) - p0
        assert np.linalg.norm(dj) > 0
        assert np.linalg.norm(dt - dj) <= 1e-2 * np.linalg.norm(dj)


def test_local_update_params_close(rounds):
    """One client's local update from the same weights: params within
    rtol 1e-4. Leaves initialised to zero (biases) hold only the update
    after it, so each element's tolerance also has a floor of 1e-4 times
    its leaf's largest magnitude."""
    js, ts, p0 = rounds["js"], rounds["ts"], rounds["p0"]
    kw = dict(local_steps=2, local_batch=2, lr=2e-3, seed=3)
    dj, mj = js.clients[1].local_update(jax.tree.map(jnp.asarray, p0), 8, **kw)
    dt, mt = ts.clients[1].local_update(convert.params_from_numpy(p0, "cpu"), 8, **kw)
    np.testing.assert_allclose(mt["loss_last"], mj["loss_last"], rtol=1e-4)
    for a, j, t in zip(jax.tree.leaves(p0), jax.tree.leaves(_np(dj)),
                       jax.tree.leaves(convert.params_to_numpy(dt))):
        want = a + j
        np.testing.assert_allclose(a + t, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_ds2_logits_and_ctc_loss_close():
    rng = np.random.RandomState(0)
    jarch = jget_arch("deepspeech2").with_(n_layers=2, d_model=32)
    tarch = tget_arch("deepspeech2").with_(n_layers=2, d_model=32)
    params = _np(jds2.init_ds2(jax.random.key(1), jarch))
    B, T = 3, 320
    batch = {
        "frames": rng.randn(B, T, 80).astype(np.float32),
        "labels": rng.randint(1, 29, size=(B, 40)).astype(np.int32),
        "frame_len": np.array([320, 300, 250], np.int32),
        "label_len": np.array([40, 30, 12], np.int32),
    }
    batch["labels"][1, 30:] = 0
    batch["labels"][2, 12:] = 0
    lj = np.asarray(jax.jit(jds2.ds2_logits, static_argnums=2)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(batch["frames"]), jarch))
    tp = convert.params_from_numpy(params, "cpu")
    lt = tds2.ds2_logits(tp, torch.from_numpy(batch["frames"]), tarch).numpy()
    assert lt.shape == lj.shape == (B, T // 4, 64)
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-5)
    loss_j = float(jax.jit(jds2.ds2_loss, static_argnums=2)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch), jarch)[0])
    loss_t = float(tds2.ds2_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 tarch)[0])
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- aggregate


def _to_port_row(r):
    return tpacking.PackedRow(data=torch.from_numpy(np.array(r.data)),
                              scale=torch.from_numpy(np.array(r.scale)),
                              bits=r.bits, qblock=r.qblock)


def test_reference_rows_aggregate(rounds):
    """The reference clients' own uplink rows through both aggregations:
    within the superpose tolerance of the reference, and exact inside the
    port (the pre-noise aggregate equals the plain left-associated group
    fold, the noisy one acc + std * noise)."""
    layout = rounds["ts"].layout
    for cap, rnd in zip(rounds["captured"], range(ROUNDS)):
        rows = [_to_port_row(r) for r in cap["rows"]]
        draws = JaxDraws(0 * 131 + rnd)
        agg, info = tota.ota_aggregate_packed(draws, rows, cap["bits"], cap["weights"],
                                              layout, tota.OTAConfig())
        assert info["participation"] == cap["info"]["participation"]
        assert info["uplink_bytes"] == cap["info"]["uplink_bytes"]
        for t, j in zip(jax.tree.leaves(convert.params_to_numpy(agg)),
                        jax.tree.leaves(cap["agg"])):
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6 * np.abs(j).max())
        w = tota.final_weights(info["participation"], cap["weights"], "cpu")
        acc = tota.ota_aggregate_packed.last_acc
        assert torch.equal(acc, tota.aggregate_plain(rows, w))
        y = tpacking.pack(agg, layout)[: layout.size]
        noise = draws.awgn(layout.size)
        std = torch.tensor(info["noise_std"], dtype=torch.float32)
        assert torch.equal(y, acc[: layout.size] + std * noise)


# ---------------------------------------------------------------- boundaries


def test_port_imports_no_jax():
    code = ("import sys; import repro_torch.fl.server, repro_torch.fl.__main__, "
            "repro_torch.convert; bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_never_import_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert files
    for f in files:
        assert not pat.search(f.read_text()), f
    assert not pat.search((ROOT / "chip_smoke.py").read_text())


def test_server_without_device_raises_on_a_cardless_machine():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TFLServer(TFLConfig(n_clients=2, clients_per_round=2),
                  tget_arch("deepspeech2").with_(**ARCH))
