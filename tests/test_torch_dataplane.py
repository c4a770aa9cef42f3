"""Parity of the PyTorch port's data plane with the JAX reference, on the
CPU: the dither hash, the uplink quantizer, the int4 pack and wire codec,
the flat layout, the storage-class grouping, and the packed OTA
superpose/fold (the kernel's plain version here; the CUDA kernel is held
against the same plain version on the card by ``chip_smoke.py``).

Inputs are made from a seed with numpy and fed to both packages. The
reference runs as its own tests run it on the CPU: the jitted jnp oracles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ota as jota
from repro.core import packing as jpacking
from repro.core import quant as jquant
from repro.core import wire as jwire
from repro.kernels import ops as jops
from repro.kernels import ota_fused as jfused
from repro.kernels import ref as jref
from repro_torch.core import ota as tota
from repro_torch.core import packing as tpacking
from repro_torch.core import quant as tquant
from repro_torch.core import wire as twire
from repro_torch.kernels import ota_fused as tfused

BITS = (2, 4, 8, 12, 16, 24, 32)
M = 4096 + 600  # not a multiple of the quant block: a ragged last block


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _row(seed, m=M, scale=0.01):
    rng = np.random.RandomState(seed)
    return (rng.randn(m) * scale * np.exp(rng.randn(m))).astype(np.float32)


# ---------------------------------------------------------------- dither


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B9, 2**32 - 1, 2**32 - 7])
@pytest.mark.parametrize("row", [0, 1, 19, 2**31 + 5, 2**32 - 1])
def test_sr_dither_bit_exact(seed, row):
    rng = np.random.RandomState(seed % 1000 + row % 1000)
    pos = np.concatenate([
        np.arange(64, dtype=np.uint64),
        rng.randint(0, 2**32, size=512, dtype=np.uint64),
        2**32 - 1 - np.arange(64, dtype=np.uint64),
    ]).astype(np.uint32)
    want = np.asarray(jfused.sr_dither(jnp.uint32(seed), jnp.uint32(row), jnp.asarray(pos)))
    got = tquant.sr_dither(seed, row, torch.from_numpy(pos.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.max() < 1.0 and got.min() >= 0.0


# ---------------------------------------------------------------- quantizer


@pytest.mark.parametrize("block", [0, 256])
@pytest.mark.parametrize("bits", BITS)
def test_quantize_row_sr_symbols_exact(bits, block):
    row = _row(bits * 7 + block)
    seed, idx = 0xC0FFEE01, 3
    qj, sj = jquant.quantize_row_sr(jnp.asarray(row), bits, jnp.uint32(seed),
                                    jnp.uint32(idx), block=block)
    qt, st = tquant.quantize_row_sr(_t(row), bits, seed, idx, block=block)
    qj, sj = np.asarray(qj), np.asarray(sj)
    assert str(qt.dtype).replace("torch.", "") == qj.dtype.name
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(st.numpy().reshape(-1).view(np.uint32),
                                  np.atleast_1d(sj).view(np.uint32))


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_fake_quant_exact(bits):
    x = _row(bits, m=3000, scale=0.1).reshape(30, 100)
    want = np.asarray(jax.jit(jquant.fake_quant, static_argnums=1)(jnp.asarray(x), bits))
    got = tquant.fake_quant(_t(x), bits).numpy()
    np.testing.assert_array_equal(got, want)


def test_ste_fake_quant_straight_through():
    x = _t(_row(5, m=64)).reshape(8, 8).requires_grad_(True)
    y = tquant.ste_fake_quant(x, 4)
    (g,) = torch.autograd.grad((y * 3.0).sum(), x)
    assert torch.equal(g, torch.full_like(x, 3.0))


# ---------------------------------------------------------------- wire


@pytest.mark.parametrize("m", [1, 2, 7, 64, 1001])
def test_int4_pack_bytes_exact(m):
    rng = np.random.RandomState(m)
    q = rng.randint(-8, 8, size=(3, m)).astype(np.int8)
    want = np.asarray(jops.pack_int4_rows(jnp.asarray(q)))
    got = twire.pack_int4_rows(_t(q)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    back = twire.unpack_int4_rows(_t(got), m).numpy()
    np.testing.assert_array_equal(back, q)
    np.testing.assert_array_equal(
        back, np.asarray(jops.unpack_int4_rows(jnp.asarray(want), m)))


@pytest.mark.parametrize("block", [0, 256])
@pytest.mark.parametrize("bits", [4, 8, 16, 24, 32])
def test_encode_row_bytes_exact(bits, block):
    row = _row(100 + bits)
    rj = jwire.encode_row(jnp.asarray(row), bits, jnp.uint32(77), 5, block=block)
    rt = twire.encode_row(_t(row), bits, 77, 5, block=block)
    dj = np.asarray(rj.data)
    np.testing.assert_array_equal(rt.data.numpy().view(np.uint8), dj.view(np.uint8))
    np.testing.assert_array_equal(rt.scale.numpy().reshape(-1),
                                  np.atleast_1d(np.asarray(rj.scale)))
    assert (rt.kind, rt.qblock, rt.bits) == (rj.kind, rj.qblock, rj.bits)
    assert rt.wire_nbytes == rj.wire_nbytes
    assert rt.wire_nbytes == tpacking.row_wire_bytes(bits, M, block)
    np.testing.assert_array_equal(twire.decode_row(rt).numpy(),
                                  np.asarray(jwire.decode_row(rj)))
    assert twire.wire_bytes([rt, rt]) == jwire.wire_bytes([rj, rj])


# ---------------------------------------------------------------- layout


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {
        "z": rng.randn(3, 4).astype(np.float32),
        "a": [
            {"w_x": rng.randn(5, 6).astype(np.float32), "b": rng.randn(6).astype(np.float32)},
            {"w_x": rng.randn(2, 2).astype(np.float32), "b": rng.randn(2).astype(np.float32)},
        ],
        "m": rng.randn(7).astype(np.float32),
    }


def test_layout_leaf_order_exact():
    tree = _tree(0)
    lj = jpacking.make_layout(jax.tree.map(jnp.asarray, tree))
    tt = jax.tree.map(_t, tree)
    lt = tpacking.make_layout(tt)
    assert (lt.shapes, lt.dtypes, lt.sizes, lt.offsets) == (
        lj.shapes, lj.dtypes, lj.sizes, lj.offsets)
    assert (lt.size, lt.padded_size) == (lj.size, lj.padded_size)
    flat_j = np.asarray(jpacking.pack(jax.tree.map(jnp.asarray, tree), lj))
    flat_t = tpacking.pack(tt, lt)
    np.testing.assert_array_equal(flat_t.numpy(), flat_j)
    back = tpacking.unpack(flat_t, lt)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(
            jax.tree.map(lambda x: x.numpy(), back))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- grouping


def _cohort(bits_list, block, seed=0, m=M):
    seed_u = 0xABCDEF
    rows_j, rows_t = [], []
    for i, b in enumerate(bits_list):
        row = _row(seed * 31 + i, m)
        rows_j.append(jwire.encode_row(jnp.asarray(row), b, jnp.uint32(seed_u), i, block=block))
        rows_t.append(twire.encode_row(_t(row), b, seed_u, i, block=block))
    return rows_j, rows_t


def test_group_rows_kinds_and_perm_exact():
    bits = [16, 4, 32, 8, 4, 1, 24, 8]
    rows_j, rows_t = _cohort(bits, 256)
    kj, dj, sj, pj = jota._group_rows(rows_j)
    kt, dt, st, pt = tota._group_rows(rows_t)
    assert kt == kj
    assert list(pt) == [int(p) for p in np.asarray(pj)]
    for a, b in zip(dt, dj):
        np.testing.assert_array_equal(a.numpy().view(np.uint8), np.asarray(b).view(np.uint8))
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------- superpose / fold


_packed_ref = jax.jit(jref.ota_packed_ref, static_argnames=("qblock", "packed4"))
_fold_ref = jax.jit(jref.ota_fold_ref, static_argnames=("qblock", "packed4"))


def _assert_close(got, want):
    """rtol 1e-4, atol 1e-6 * max|ref|: the K-sum is reassociated."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("gained", [False, True])
@pytest.mark.parametrize("block", [0, 256])
@pytest.mark.parametrize("bits", [4, 8, 16, 24, 32])
def test_superpose_fold_match_jitted_oracle(bits, block, gained):
    K = 5
    rows_j, rows_t = _cohort([bits] * K, block, seed=bits + block)
    (kind, qblock), = tota._group_rows(rows_t)[0]
    _, dj, sj, _ = jota._group_rows(rows_j)
    _, dt, st, _ = tota._group_rows(rows_t)
    rng = np.random.RandomState(bits)
    w = rng.rand(K).astype(np.float32)
    g = rng.rand(K).astype(np.float32) if gained else None
    acc = rng.randn(M).astype(np.float32)
    kw_j = dict(qblock=qblock, packed4=kind == "int4",
                gains=None if g is None else jnp.asarray(g))
    kw_t = dict(qblock=qblock, packed4=kind == "int4", gains=None if g is None else _t(g))
    sup = tfused.ota_superpose(dt[0], st[0], _t(w), **kw_t)
    _assert_close(sup.numpy(), _packed_ref(dj[0], sj[0], jnp.asarray(w), **kw_j))
    fold = tfused.ota_fold(_t(acc), dt[0], st[0], _t(w), **kw_t)
    _assert_close(fold.numpy(), _fold_ref(jnp.asarray(acc), dj[0], sj[0], jnp.asarray(w), **kw_j))
    # the reference's own identity, exact inside the port
    fold0 = tfused.ota_fold(torch.zeros(M), dt[0], st[0], _t(w), **kw_t)
    assert torch.equal(fold0, sup)


def test_cpu_tensors_take_the_plain_version():
    rows_j, rows_t = _cohort([8, 8], 0)
    _, dt, st, _ = tota._group_rows(rows_t)
    before = (tfused.ota_superpose.launches, tfused.ota_fold.launches)
    out = tfused.ota_superpose(dt[0], st[0], torch.ones(2))
    assert torch.equal(out, tfused.superpose_plain(dt[0], st[0], torch.ones(2)))
    assert (tfused.ota_superpose.launches, tfused.ota_fold.launches) == before


def test_mixed_cohort_aggregate_with_injected_draws():
    """The whole packed barrier path on a mixed 4/8/16/32-bit cohort, with
    the reference's own round-key draws injected."""
    bits = [4, 8, 16, 32, 4, 8]
    rows_j, rows_t = _cohort(bits, 256, seed=3)
    tree = {"w": jnp.zeros((M,), jnp.float32)}
    layout_j = jpacking.make_layout(tree)
    layout_t = tpacking.make_layout({"w": torch.zeros(M)})
    weights = np.random.RandomState(9).rand(len(bits)).astype(np.float32)
    key = jax.random.key(1234)
    agg_j, info_j = jota.ota_aggregate_packed(
        key, rows_j, bits, jnp.asarray(weights), layout_j, jota.OTAConfig())

    class Draws(tota.RoundDraws):
        def channel(self, k, ft):
            h, p = jota.sample_channel(jax.random.split(key, 3)[0], k, ft)
            return _t(np.asarray(h)), _t(np.asarray(p))

        def awgn(self, n):
            return _t(np.asarray(jax.random.normal(jax.random.split(key, 3)[2], (n,))))

    agg_t, info_t = tota.ota_aggregate_packed(
        Draws(), rows_t, bits, weights, layout_t, tota.OTAConfig())
    assert info_t["participation"] == info_j["participation"]
    assert info_t["n_participating"] == info_j["n_participating"]
    assert info_t["uplink_bytes"] == info_j["uplink_bytes"]
    np.testing.assert_allclose(info_t["noise_std"], info_j["noise_std"], rtol=1e-4)
    _assert_close(agg_t["w"].numpy(), agg_j["w"])
    # inside the port: pre-noise aggregate == the plain left-associated fold
    w = tota.final_weights(info_t["participation"], weights, "cpu")
    assert torch.equal(tota.ota_aggregate_packed.last_acc, tota.aggregate_plain(rows_t, w))


def test_ref_qmax_matches_reference_jit_for_every_width():
    """The reference's jitted exp2(f32(b - 1)) - 1 (not an integer for
    many widths) is what the port's uplink grid uses."""
    for bits in range(2, 32):
        want = np.float32(jax.jit(lambda b=bits: jnp.exp2(jnp.float32(b - 1)) - 1.0)())
        assert np.float32(tquant.ref_qmax(bits)) == want, bits
