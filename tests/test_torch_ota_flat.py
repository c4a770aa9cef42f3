"""Parity of the port's one-shot f32 aggregation with the JAX reference, on
the CPU: the per-row grid (``_client_grid``), the in-pass quantize-superpose
(the kernel's plain version here; the CUDA kernel is held against the same
plain version on the card), ``ota_aggregate_packed`` on the (K, M) f32
matrix and ``ota_aggregate`` on update trees.

The reference runs as its own tests run it on the CPU: the jitted jnp
oracle ``ref.ota_fused_ref`` (its eager run differs from the jitted one)
and the jitted ``ota_aggregate_flat``, with its own round-key draws handed
to the port through the round-draws seam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ota as jota
from repro.core import packing as jpacking
from repro.kernels import ref as jref
from repro_torch.core import ota as tota
from repro_torch.core import packing as tpacking
from repro_torch.kernels import ota_fused as tfused
from test_torch_fl import JaxDraws

BITS = (2, 4, 8, 16, 24, 31, 32)
M = 4096 + 600  # not a multiple of the reference kernel's 2048-column tile
SEED = 0xC0FFEE01

_fused_ref = jax.jit(jref.ota_fused_ref)
_grid_ref = jax.jit(jota._client_grid)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rows(seed, k, m=M):
    rng = np.random.RandomState(seed)
    return (rng.randn(k, m) * 0.01 * np.exp(rng.randn(k, m))).astype(np.float32)


def _grids(bits, x):
    """The reference's jitted grid on traced bits, and the port's; exact."""
    amax = np.abs(x).max(axis=1)
    sj, qj = map(np.asarray, _grid_ref(jnp.asarray(bits, jnp.int32), jnp.asarray(amax)))
    st, qt = tota._client_grid(bits, _t(amax))
    np.testing.assert_array_equal(st.numpy().view(np.uint32), sj.view(np.uint32))
    np.testing.assert_array_equal(qt.numpy().view(np.uint32), qj.view(np.uint32))
    return st, qt


def test_client_grid_qmax_is_the_reference_table():
    """qmax for every width 2-31 as the reference's jitted program gives it
    (not an integer for many widths), 0 at 32 bits with scale 1."""
    bits = list(range(2, 33))
    st, qt = _grids(bits, _rows(0, len(bits), m=64))
    assert float(qt[bits.index(16)]) == 32766.984375
    assert float(qt[bits.index(24)]) == 8388603.5
    assert float(qt[-1]) == 0.0 and float(st[-1]) == 1.0


@pytest.mark.parametrize("m", [M, 2048, 1001])
@pytest.mark.parametrize("bits", BITS)
def test_single_row_dequantized_bit_exact(bits, m):
    """K = 1, w = 1: the aggregate is the dequantized row itself, so the
    plain version equals the jitted oracle bit for bit; the sum of squares
    within rtol 1e-5 (summation order)."""
    x = _rows(bits * 3 + m, 1, m)
    st, qt = _grids([bits], x)
    w = np.ones(1, np.float32)
    aj, sj = _fused_ref(jnp.asarray(x), jnp.asarray(st.numpy()), jnp.asarray(qt.numpy()),
                        jnp.asarray(w), jnp.uint32(SEED))
    at, stt = tfused.quantize_superpose_plain(_t(x), st, qt, _t(w), SEED)
    np.testing.assert_array_equal(at.numpy().view(np.uint32), np.asarray(aj).view(np.uint32))
    np.testing.assert_allclose(float(stt), float(sj), rtol=1e-5)


def test_all_zero_row_bit_exact():
    x = np.zeros((1, M), np.float32)
    for bits in (4, 16, 32):
        st, qt = _grids([bits], x)
        aj, sj = _fused_ref(jnp.asarray(x), jnp.asarray(st.numpy()), jnp.asarray(qt.numpy()),
                            jnp.ones(1), jnp.uint32(SEED))
        at, stt = tfused.quantize_superpose_plain(_t(x), st, qt, torch.ones(1), SEED)
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        assert float(stt) == float(sj) == 0.0


@pytest.mark.parametrize("bits", [[4, 8, 16, 32, 24, 2], [8] * 5, [32] * 3])
def test_cohort_superpose_close(bits):
    """K > 1: XLA sums the K products in its own order (and may fuse the
    multiply into the add), the port in k order: acc within rtol 1e-5 and
    atol 1e-6 of max |acc|, sumsq within rtol 1e-5."""
    k = len(bits)
    x = _rows(k, k)
    st, qt = _grids(bits, x)
    w = np.random.RandomState(1).rand(k).astype(np.float32)
    aj, sj = _fused_ref(jnp.asarray(x), jnp.asarray(st.numpy()), jnp.asarray(qt.numpy()),
                        jnp.asarray(w), jnp.uint32(SEED))
    at, stt = tfused.quantize_superpose_plain(_t(x), st, qt, _t(w), SEED)
    aj = np.asarray(aj)
    np.testing.assert_allclose(at.numpy(), aj, rtol=1e-5, atol=1e-6 * np.abs(aj).max())
    np.testing.assert_allclose(float(stt), float(sj), rtol=1e-5)
    assert torch.equal(stt, (at * at).sum())


def test_cpu_tensors_take_the_plain_version():
    x = _rows(2, 3)
    st, qt = tota._client_grid([4, 8, 32], _t(np.abs(x).max(axis=1)))
    before = tfused.ota_quantize_superpose.launches
    got = tfused.ota_quantize_superpose(_t(x), st, qt, torch.ones(3), 5)
    want = tfused.quantize_superpose_plain(_t(x), st, qt, torch.ones(3), 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tfused.ota_quantize_superpose.launches == before


def test_quantize_superpose_in_one_pass_equals_chunked_passes():
    """K = 9 rows in one pass, and as rows 0-3 then rows 4-8 continuing the
    first pass's aggregate at their global row index (how the card runs a
    cohort above its per-launch row limit): bit for bit, sum of squares
    included."""
    x = _rows(11, 9)
    bits = [2, 4, 8, 16, 32, 24, 4, 31, 8]
    st, qt = tota._client_grid(bits, _t(np.abs(x).max(axis=1)))
    w = _t(np.random.RandomState(12).uniform(0.1, 1.0, 9).astype(np.float32))
    one, ss_one = tfused.quantize_superpose_plain(_t(x), st, qt, w, SEED)
    a, _ = tfused.quantize_superpose_plain(_t(x[:4]), st[:4], qt[:4], w[:4], SEED)
    two, ss_two = tfused.quantize_superpose_plain(_t(x[4:]), st[4:], qt[4:], w[4:], SEED,
                                                  acc_in=a, k0=4)
    assert torch.equal(one, two) and torch.equal(ss_one, ss_two)
    # the dither follows the global row: the second chunk at k0 = 0 differs
    wrong, _ = tfused.quantize_superpose_plain(_t(x[4:]), st[4:], qt[4:], w[4:], SEED,
                                               acc_in=a)
    assert not torch.equal(one, wrong)


def _trees(k, seed=0):
    rng = np.random.RandomState(seed)
    return [
        {
            "conv": (rng.randn(7, 5) * 0.02).astype(np.float32),
            "gru": [
                {"w": (rng.randn(33, 9) * 0.01).astype(np.float32),
                 "b": (rng.randn(9) * 0.001).astype(np.float32)},
            ],
            "out": (rng.randn(300) * 0.05).astype(np.float32),
        }
        for _ in range(k)
    ]


def _tree_close(got, want):
    for t, j in zip(jax.tree.leaves(jax.tree.map(lambda a: a.numpy(), got)),
                    jax.tree.leaves(want)):
        j = np.asarray(j)
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6 * np.abs(j).max())


@pytest.mark.parametrize("round_seed", [0, 7, 1234])
def test_ota_aggregate_trees_match_reference(round_seed):
    """The pytree entry with the reference's own draws: participation and
    byte-free info exact; noise_std within rtol 1e-4 and the aggregate within
    rtol 1e-4 (the K-sum and the sum of squares are reassociated, and the
    noise is scaled by noise_std)."""
    bits = [4, 8, 16, 32, 8, 2]
    trees = _trees(len(bits), round_seed)
    weights = np.random.RandomState(round_seed).rand(len(bits)).astype(np.float32) + 0.5
    key = jax.random.key(round_seed)
    agg_j, info_j = jota.ota_aggregate(key, [jax.tree.map(jnp.asarray, t) for t in trees],
                                       bits, jnp.asarray(weights), jota.OTAConfig())
    agg_t, info_t = tota.ota_aggregate(JaxDraws(round_seed), [jax.tree.map(_t, t) for t in trees],
                                       bits, weights, tota.OTAConfig())
    assert info_t["participation"] == info_j["participation"]
    assert info_t["n_participating"] == info_j["n_participating"]
    # |h| from the eager draw vs inside the reference's jitted program: rtol 1e-6
    np.testing.assert_allclose(info_t["channel_abs"], info_j["channel_abs"], rtol=1e-6)
    np.testing.assert_allclose(info_t["noise_std"], info_j["noise_std"], rtol=1e-4)
    _tree_close(agg_t, agg_j)
    assert set(info_t) == set(info_j)


def test_f32_matrix_branch_of_ota_aggregate_packed():
    """The (K, M) f32 matrix through ``ota_aggregate_packed``: the
    reference's ``ota_aggregate_flat`` within tolerance; inside the port
    the pre-noise aggregate is the plain quantize-superpose with the final
    weights and the round's seed, exactly, and the noisy result is acc +
    std * noise with std from the pass's own sum of squares."""
    bits = [16, 4, 32, 8]
    trees = _trees(len(bits), 3)
    layout_j = jpacking.make_layout(jax.tree.map(jnp.asarray, trees[0]))
    layout_t = tpacking.make_layout(jax.tree.map(_t, trees[0]))
    Xj = jpacking.pack_batch([jax.tree.map(jnp.asarray, t) for t in trees], layout_j)
    Xt = tpacking.pack_batch([jax.tree.map(_t, t) for t in trees], layout_t)
    np.testing.assert_array_equal(Xt.numpy(), np.asarray(Xj))
    weights = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    key = jax.random.key(99)
    agg_j, info_j = jota.ota_aggregate_packed(key, Xj, bits, jnp.asarray(weights), layout_j)
    draws = JaxDraws(99)
    agg_t, info_t = tota.ota_aggregate_packed(draws, Xt, bits, weights, layout_t)
    assert info_t["participation"] == info_j["participation"]
    np.testing.assert_allclose(info_t["noise_std"], info_j["noise_std"], rtol=1e-4)
    _tree_close(agg_t, agg_j)
    w = tota.final_weights(info_t["participation"], weights, "cpu")
    st, qt = tota._client_grid(bits, Xt.abs().amax(dim=1))
    acc, sumsq = tfused.quantize_superpose_plain(Xt, st, qt, w, draws.sr_seed)
    assert torch.equal(tota.ota_aggregate_packed.last_acc, acc)
    y = tpacking.pack(agg_t, layout_t)[: layout_t.size]
    std = torch.sqrt(sumsq / torch.tensor(float(layout_t.size)) * (10 ** (-20.0 / 10)))
    assert float(std) == info_t["noise_std"]
    assert torch.equal(y, acc[: layout_t.size] + std * draws.awgn(layout_t.size))
    with pytest.raises(ValueError, match="gains="):
        tota.ota_aggregate_packed(draws, Xt, bits, weights, layout_t, gains=torch.ones(4))


def test_value_equal_to_its_dither_rounds_down():
    """x == u on a unit grid: frac == u exactly, and the reference rounds up
    only when u < frac, so every symbol is 0 in both packages."""
    from repro_torch.core.quant import sr_dither

    m = 3000
    u = sr_dither(SEED, 0, torch.arange(m, dtype=torch.int64)).reshape(1, m)
    one, qmax = torch.ones(1), torch.full((1,), 127.0)
    acc, _ = tfused.quantize_superpose_plain(u, one, qmax, torch.ones(1), SEED)
    aj, _ = _fused_ref(jnp.asarray(u.numpy()), jnp.ones(1), jnp.full((1,), 127.0), jnp.ones(1),
                       jnp.uint32(SEED))
    assert not acc.any()
    np.testing.assert_array_equal(acc.numpy(), np.asarray(aj))
