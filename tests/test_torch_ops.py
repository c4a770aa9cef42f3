"""Parity of the port's kernel entry points (``repro_torch.kernels.ops``)
with the JAX package's ``repro.kernels.ops``, on the CPU: fake-quant,
the OTA aggregate, the weight quantizer, the int4 packs, the weight-only
int8/int4 matrix product, the packed OTA superpose and fold, and the cosine
top-k (flash attention: ``tests/test_torch_flash.py``).

Inputs are made from a fixed seed with numpy and fed to both packages. The
reference runs as its own tests run it on the CPU: its jitted entry points
with the Pallas kernels in interpret mode. The port runs the kernels' plain
versions here (CPU tensors); ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` hold the CUDA kernels against the same plain versions on
the card.

Tolerances: fake-quant, the weight quantizer and the int4 pack are bit for
bit (correctly rounded elementwise math and integer ops). The OTA aggregate
is a sum of K products in another order than XLA's, so it is held to the
f32 summation bound 2 K 2**-24 (|w| @ |x| + |std noise|) per element. The
matrix product is held to ``kernels.qmatmul.mismatch``'s rule,
``TOL_C`` sqrt(K) 2**-24 (|x| @ |w_deq|) per element. The packed superpose
and fold reassociate the K-sum: rtol 1e-4, atol 1e-6 max |reference|, as in
``tests/test_torch_dataplane.py``. The top-k's indices are bit for bit (the
tie contract), its scores within 1e-6.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jkernels
from repro.core.quant import qrange
from repro.kernels import ops as jops
from repro.kernels import quantize as jquantize
import repro_torch.kernels as tkernels
from repro_torch.core import wire
from repro_torch.kernels import _build, ota_fused, topk_similarity
from repro_torch.kernels import ops as tops
from repro_torch.kernels.qmatmul import (TOL_C, cluster_split, kernel_design, mismatch,
                                         one_hot_reference, qmatmul_planes_plain, split3_plain,
                                         ulps)
from repro_torch.kernels.quantize import fake_quant_2d, fake_quant_plain

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """The f32 numpy array a as a JAX array and a torch tensor of one dtype
    (both round the same f32 values to bf16 half to even)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.array(a, copy=True)).to(td)


def _t(a):
    """A torch tensor of a copy of the numpy (or JAX) array a."""
    return torch.from_numpy(np.array(a, copy=True))


def _bits_j(a):
    """The bit patterns of a JAX array (as f32)."""
    return np.asarray(jnp.asarray(a, jnp.float32)).view(np.uint32)


def _bits_t(t):
    return t.to(torch.float32).numpy().view(np.uint32)


# ----------------------------------------------------------------- fake-quant


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 128), (100, 257), (3, 5000), (1, 64)])
def test_fake_quant_bit_equal_to_jitted_reference(shape, dtype, bits):
    a = np.random.RandomState(sum(shape) + bits).randn(*shape).astype(np.float32)
    xj, xt = _pair(a, dtype)
    got = tops.fake_quant(xt, bits)
    want = jops.fake_quant(xj, bits)
    assert got.shape == shape and got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(_bits_t(got), _bits_j(want))


def test_fake_quant_takes_the_jitted_scale_at_the_rounding_boundary_example():
    """n=3131, bits=16, seed=36909: the example on which the reference's own
    ``test_fake_quant_kernel_matches_ref`` fails. Its eager scale (a true
    division) and the jitted one (a multiply by the reciprocal of qmax) are
    one ulp apart; the port takes the jitted one and matches bit for bit."""
    rng = np.random.RandomState(36909)
    a = rng.randn(3131).astype(np.float32) * rng.uniform(0.1, 10)
    xj, xt = _pair(a, "float32")
    eager = jnp.maximum(jnp.max(jnp.abs(xj)), 1e-12) / qrange(16)
    scale = tops.fake_quant_scale(xt, 16)
    assert float(eager).hex() == "0x1.a683300000000p-11"
    assert float(scale).hex() == "0x1.a6832e0000000p-11"
    np.testing.assert_array_equal(_bits_t(tops.fake_quant(xt, 16)),
                                  _bits_j(jops.fake_quant(xj, 16)))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,shape", [(4, (256, 128)), (8, (512, 256)), (16, (256, 384))])
def test_fake_quant_2d_bit_equal_to_interpret_kernel(bits, shape, dtype, stochastic):
    """The 2-D level with one scale and one numpy noise array for both."""
    rng = np.random.RandomState(bits)
    a = (rng.randn(*shape) * 3.0).astype(np.float32)
    noise = rng.uniform(0, 1, shape).astype(np.float32) if stochastic else None
    xj, xt = _pair(a, dtype)
    s = np.float32(np.abs(a).max() / 7.3)
    want = jquantize.fake_quant_2d(xj, jnp.float32(s), bits,
                                   None if noise is None else jnp.asarray(noise), interpret=True)
    got = fake_quant_2d(xt, torch.tensor(s), bits,
                        None if noise is None else torch.from_numpy(noise))
    np.testing.assert_array_equal(_bits_t(got), _bits_j(want))


def test_fake_quant_stochastic_is_unbiased():
    """As the reference's test_fake_quant_kernel_stochastic_unbiased: the
    mean of 48 draws (seeded generators) is within 5 sigma of x."""
    xt = torch.from_numpy(np.random.RandomState(1).randn(512).astype(np.float32))
    outs = torch.stack([
        tops.fake_quant(xt, 4, stochastic=True, generator=torch.Generator().manual_seed(i))
        for i in range(48)
    ])
    scale = float(xt.abs().max()) / qrange(4)
    err = (outs.mean(0) - xt).abs().max().item()
    assert err < 5 * scale / (2 * np.sqrt(48)) + 1e-6
    # and the draws do differ: not round-to-nearest
    assert not torch.equal(outs[0], outs[1])


# ------------------------------------------------------------- ota aggregate


@pytest.mark.parametrize("K", [1, 7, 20])
@pytest.mark.parametrize("M", [2049, 4133])
def test_ota_aggregate_within_summation_bound_of_reference(K, M):
    rng = np.random.RandomState(K * M)
    x = rng.randn(K, M).astype(np.float32)
    w = rng.uniform(0, 1, K).astype(np.float32)
    noise = rng.randn(M).astype(np.float32)
    std = np.float32(0.1)
    want = np.asarray(jops.ota_aggregate(jnp.asarray(x), jnp.asarray(w), jnp.asarray(noise),
                                         jnp.float32(std)))
    got = tops.ota_aggregate(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(noise),
                             float(std)).numpy()
    mag = np.abs(w) @ np.abs(x) + np.abs(std * noise)
    assert got.shape == (M,) and got.dtype == np.float32
    assert (np.abs(got - want) <= 2 * K * 2.0**-24 * mag).all()


# --------------------------------------------------------- weights and int4


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 48), (300, 257)])
def test_quantize_weights_bit_equal_to_reference(shape, dtype, bits):
    a = (np.random.RandomState(shape[0] + bits).randn(*shape) * 0.02).astype(np.float32)
    a[:, 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    wj, wt = _pair(a, dtype)
    qj, sj = jops.quantize_weights(wj, bits)
    qt, st = tops.quantize_weights(wt, bits)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32), np.asarray(sj).view(np.uint32))


@pytest.mark.parametrize("shape", [(2, 1), (64, 48), (130, 7)])
def test_pack_unpack_int4_bit_equal_to_reference(shape):
    q = np.random.RandomState(shape[1]).randint(-8, 8, size=shape).astype(np.int8)
    pj = np.asarray(jops.pack_int4(jnp.asarray(q)))
    pt = tops.pack_int4(torch.from_numpy(q))
    assert pt.dtype == torch.uint8 and pt.shape == (shape[0] // 2, shape[1])
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(tops.unpack_int4(pt).numpy(),
                                  np.asarray(jops.unpack_int4(jnp.asarray(pj))))
    np.testing.assert_array_equal(tops.unpack_int4(pt).numpy(), q)


def test_quantize_weights_int4_bit_equal_to_reference():
    a = (np.random.RandomState(5).randn(128, 64) * 0.02).astype(np.float32)
    pj, sj = jops.quantize_weights_int4(jnp.asarray(a))
    pt, st = tops.quantize_weights_int4(torch.from_numpy(a))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


# ------------------------------------------------------------------ qmatmul


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(4, 256, 384), (37, 300, 129), (130, 129, 200),
                                   # ragged and odd shapes: the routes of w TMA cannot load
                                   (17, 100, 24), (5, 64, 1001), (33, 130, 15)])
def test_qmatmul_within_tolerance_of_reference(m, k, n, dtype):
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    xj, xt = _pair(x, dtype)
    qj, sj = jops.quantize_weights(jnp.asarray(w), 8)
    want = np.asarray(jops.qmatmul(xj, qj, sj))
    qt, st = _t(np.asarray(qj)), _t(np.asarray(sj))
    got = tops.qmatmul(xt, qt, st)
    assert got.shape == (m, n) and got.dtype == torch.float32
    mm = mismatch(got, _t(want), xt, qt, st)
    assert mm["within"], mm


def test_qmatmul_int4_within_tolerance_of_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(32, 128).astype(np.float32)
    w = rng.randn(128, 64).astype(np.float32)
    pj, sj = jops.quantize_weights_int4(jnp.asarray(w))
    want = np.asarray(jops.qmatmul_int4(jnp.asarray(x), pj, sj))
    pt, st = _t(np.asarray(pj)), _t(np.asarray(sj))
    got = tops.qmatmul_int4(torch.from_numpy(x), pt, st)
    mm = mismatch(got, _t(want), torch.from_numpy(x), tops.unpack_int4(pt), st)
    assert mm["within"], mm


def test_qmatmul_mismatch_rule_bounds_each_element():
    """The rule passes the plain version against itself and flags one
    element moved by a little more than its bound."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(8, 512).astype(np.float32))
    q, s = tops.quantize_weights(torch.from_numpy(rng.randn(512, 16).astype(np.float32)))
    plain = tops.qmatmul(x, q, s)
    assert mismatch(plain, plain, x, q, s) == {
        "max_abs_err": 0.0, "max_ratio": 0.0, "over_element_bound": 0, "within": True}
    mag = x.abs() @ (q.float().abs() * s)
    bad = plain.clone()
    bad[2, 5] += 1.5 * TOL_C * math.sqrt(512) * 2.0**-24 * mag[2, 5]
    mm = mismatch(bad, plain, x, q, s)
    assert mm["over_element_bound"] == 1 and not mm["within"]


@pytest.mark.parametrize("dtype,M,K,N,x_off,w_off,want", [
    (torch.bfloat16, 17, 64, 16, 0, 0, "hopper"),  # the smallest Hopper call
    (torch.bfloat16, 8192, 4096, 12288, 0, 0, "hopper"),  # Qwen3-8B w_gate at prefill
    (torch.bfloat16, 1000, 4104, 1008, 0, 0, "hopper"),  # ragged inside the route
    (torch.bfloat16, 16, 64, 16, 0, 0, "decode"),  # a decode step: one cluster launch
    (torch.bfloat16, 4, 4096, 12288, 0, 0, "decode"),  # Qwen3-8B w_gate at batch 4
    (torch.bfloat16, 16, 64, 16, 1, 0, "decode"),  # x off alignment: plain loads of x
    (torch.bfloat16, 16, 100, 16, 0, 0, "decode"),  # K % 8: the decode route takes it
    (torch.bfloat16, 17, 100, 16, 0, 0, "hopper"),  # K % 8: x repitched for TMA
    (torch.bfloat16, 17, 64, 16, 1, 0, "hopper"),  # x a view 2 bytes off alignment
    (torch.bfloat16, 17, 64, 24, 0, 0, "hopper_ldw"),  # N % 16: w's rows not 16-byte multiples
    (torch.bfloat16, 17, 64, 16, 0, 1, "hopper_ldw"),  # w a view 1 byte off alignment
    (torch.bfloat16, 4, 64, 16, 0, 1, "decode_ldw"),  # w off alignment at a decode step
    (torch.bfloat16, 4, 4096, 12280, 0, 0, "decode_ldw"),  # a ragged N at batch 4
    (torch.bfloat16, 17, 64, 16, 8, 16, "hopper"),  # views 16 bytes in: aligned again
    (torch.float32, 8192, 4096, 12288, 0, 0, "hopper_f32"),  # through the three planes
    (torch.float32, 1000, 4104, 1008, 0, 0, "hopper_f32"),
    (torch.float32, 17, 100, 16, 1, 0, "hopper_f32"),  # the planes pass takes any x
    (torch.float32, 4, 64, 16, 0, 0, "decode"),
    (torch.float32, 4, 12288, 4096, 0, 0, "decode"),  # Qwen3-8B w_down at batch 4
    (torch.float32, 4, 64, 24, 0, 0, "decode_ldw"),  # N % 16
    (torch.float32, 1000, 64, 16, 0, 1, "hopper_f32_ldw"),  # w off alignment
    (torch.float32, 1000, 4096, 12280, 0, 0, "hopper_f32_ldw"),  # a ragged N
])
def test_kernel_design_takes_hopper_only_where_tma_can_load(dtype, M, K, N, x_off, w_off,
                                                             want):
    x = torch.zeros(x_off + min(M * K, 1 << 16), dtype=dtype)[x_off:]
    w = torch.zeros(w_off + min(K * N, 1 << 16), dtype=torch.int8)[w_off:]
    assert x.data_ptr() % 16 == (2 if dtype == torch.bfloat16 else 4) * x_off % 16
    assert kernel_design(dtype, M, N, w) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [4, 300])
@pytest.mark.parametrize("w_off", range(1, 16))
def test_kernel_design_loads_w_itself_at_every_byte_offset(dtype, M, w_off):
    """w a view 1-15 bytes past a 16-byte boundary is no TMA source at any
    offset: its producers load it (the ``_ldw`` routes); 16 bytes in, TMA
    takes it again."""
    w = torch.zeros(32 + 64 * 16, dtype=torch.int8)
    route = "decode" if M <= 16 else "hopper" if dtype == torch.bfloat16 else "hopper_f32"
    assert kernel_design(dtype, M, 16, w[w_off:]) == route + "_ldw"
    assert kernel_design(dtype, M, 16, w[16:]) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [4, 300])
# N % 16 in {1, 8, 15}; an odd N; narrower than a 16-byte block
@pytest.mark.parametrize("N", [12289, 12296, 12303, 1001, 10, 14])
def test_kernel_design_loads_w_itself_at_a_ragged_n(dtype, M, N):
    w = torch.zeros(64 * N, dtype=torch.int8)
    assert w.data_ptr() % 16 == 0 and kernel_design(dtype, M, N, w).endswith("_ldw")


def test_kernel_design_rejects_what_no_kernel_takes():
    x = torch.zeros((17, 64), dtype=torch.float16)
    with pytest.raises(ValueError):
        kernel_design(torch.float16, 17, 16, torch.zeros((64, 16), dtype=torch.int8))


@pytest.mark.parametrize("N,K,sms", [(12288, 4096, 132), (4096, 12288, 132), (16, 64, 132),
                                     (1008, 4104, 132), (48, 576, 132), (12288, 4096, 114)])
def test_cluster_split_cuts_k_into_nonempty_ranges(N, K, sms):
    S, k_chunk = cluster_split(N, K, sms)
    assert S in (1, 2, 4, 8) and k_chunk % 64 == 0
    assert (S - 1) * k_chunk < K <= S * k_chunk


def test_cluster_split_gives_every_sm_a_cta_with_the_fewest_splits():
    """96 tiles of w_gate need 2 splits for 132 SMs, w_down's 32 need 8; a
    shape with a tile an SM already is not split, and one too shallow for
    more ranges stops where every range still holds k."""
    assert cluster_split(12288, 4096, 132) == (2, 2048)
    assert cluster_split(4096, 12288, 132) == (8, 1536)
    assert cluster_split(32768, 4096, 132) == (1, 4096)
    assert cluster_split(16, 192, 132) == (2, 128)


def _f32_with_exponents(rng, shape, lo, hi):
    """f32 values with random 23-bit fractions, both signs, exponents in
    [lo, hi]."""
    frac = rng.randint(0, 1 << 23, size=shape).astype(np.int64)
    exp = rng.randint(lo, hi + 1, size=shape)
    sign = rng.randint(0, 2, size=shape)
    bits = (sign << 31) | ((exp + 127) << 23) | frac
    return bits.astype(np.uint32).view(np.float32)


def test_split3_plain_sums_back_to_x_exactly():
    """hi + mid + lo == x in f32, bit for bit, over exponents 2**-100 to
    2**127, both signs and +-0 (-0 sums back to +0); each part a bf16 that
    holds the value it was given."""
    rng = np.random.RandomState(35)
    x = _f32_with_exponents(rng, (4096,), -100, 127)
    x[:4] = [0.0, -0.0, np.float32(2.0**-100), np.float32(-(2.0 - 2.0**-23) * 2.0**127)]
    xt = torch.from_numpy(x)
    hi, mid, lo = split3_plain(xt)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = (hi.float() + mid.float()) + lo.float()
    nz = x != 0  # -0 sums back to +0, the same value
    np.testing.assert_array_equal(back.numpy().view(np.uint32)[nz], x.view(np.uint32)[nz])
    assert (back.numpy()[~nz] == 0).all() and hi[1].float().item() == 0.0
    # the sum order does not matter: every partial sum is exact
    np.testing.assert_array_equal(((lo.float() + mid.float()) + hi.float()).numpy(), x)
    assert (lo.float().abs() <= mid.float().abs()).all() and (mid.float().abs() <= hi.float().abs()).all()


def test_split3_plain_keeps_non_finite_x_in_hi():
    x = torch.tensor([math.inf, -math.inf, math.nan, 1.5], dtype=torch.float32)
    x = torch.cat([x, torch.tensor([0x7F800001, -8388607], dtype=torch.int32).view(torch.float32)])
    hi, mid, lo = split3_plain(x)
    assert hi[0].item() == math.inf and hi[1].item() == -math.inf
    assert math.isnan(hi[2].item()) and math.isnan(hi[4].item()) and math.isnan(hi[5].item())
    assert (mid[:3] == 0).all() and (lo[:3] == 0).all() and (mid[4:] == 0).all()
    assert (lo[4:] == 0).all() and hi[3].item() == 1.5


@pytest.mark.parametrize("m,k,n", [(4, 256, 384), (37, 300, 129), (130, 129, 200)])
def test_qmatmul_planes_plain_within_tolerance_of_reference(m, k, n):
    """The three-plane product (the CUDA routes' f32 arithmetic) against the
    JAX kernel at the f32 shapes above."""
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    qj, sj = jops.quantize_weights(jnp.asarray(w), 8)
    want = np.asarray(jops.qmatmul(jnp.asarray(x), qj, sj))
    xt, qt, st = torch.from_numpy(x), _t(np.asarray(qj)), _t(np.asarray(sj))
    mm = mismatch(qmatmul_planes_plain(xt, qt, st), _t(want), xt, qt, st)
    assert mm["within"], mm


def test_one_hot_planes_within_two_ulps_and_a_dropped_lo_plane_flagged():
    """One nonzero a row with a full 24-bit mantissa: the three-plane
    product is within 2 ulps of ``qmatmul_plain`` and bit for bit the
    reference kernel's rounding of that product (lo q + mid q is exact, so
    adding hi q rounds the dot once); without its lo plane it is neither (a
    dropped lo plane reads well under TOL_C, so the tolerance alone cannot
    see it)."""
    rng = np.random.RandomState(7)
    M, K, N = 64, 512, 96
    x = np.zeros((M, K), np.float32)
    vals = _f32_with_exponents(rng, (M,), -20, 20)
    vals = (vals.view(np.uint32) | 1).view(np.float32)  # the 24th bit set
    x[np.arange(M), rng.randint(0, K, M)] = vals
    xt = torch.from_numpy(x)
    qt, st = tops.quantize_weights(torch.from_numpy(rng.randn(K, N).astype(np.float32)))
    plain = tops.qmatmul(xt, qt, st)
    planes = qmatmul_planes_plain(xt, qt, st)
    assert int(ulps(planes, plain).max()) <= 2
    assert torch.equal(planes, one_hot_reference(xt, qt, st))
    no_lo = qmatmul_planes_plain(xt, qt, st, planes=(True, True, False))
    assert int(ulps(no_lo, plain).max()) > 2
    assert int(ulps(no_lo, one_hot_reference(xt, qt, st)).max()) > 2
    # on a dense x at Qwen3-8B's K the same fault stays inside the rule
    x = torch.from_numpy(rng.randn(16, 4096).astype(np.float32))
    q, s = tops.quantize_weights(torch.from_numpy(rng.randn(4096, 64).astype(np.float32)))
    no_lo = qmatmul_planes_plain(x, q, s, planes=(True, True, False))
    assert mismatch(no_lo, tops.qmatmul(x, q, s), x, q, s)["within"]


def test_qmatmul_planes_plain_within_tolerance_at_tiny_exponents():
    """x near 2**-100 (lo's bits near 2**-123, still normal in bf16)."""
    rng = np.random.RandomState(11)
    x = _f32_with_exponents(rng, (8, 256), -101, -99)
    qt, st = tops.quantize_weights(torch.from_numpy(rng.randn(256, 32).astype(np.float32)))
    xt = torch.from_numpy(x)
    assert mismatch(qmatmul_planes_plain(xt, qt, st), tops.qmatmul(xt, qt, st), xt, qt, st)["within"]


# ------------------------------------------------- packed superpose and fold


def _group(kind, K, M, qblock, seed):
    """One storage group's symbols (numpy), scales, weights, gains and acc."""
    rng = np.random.RandomState(seed)
    if kind == "int4":
        q = rng.randint(0, 256, (K, M // 2)).astype(np.uint8)
    elif kind == "float32":
        q = (rng.randn(K, M) * 1e-2).astype(np.float32)
    else:
        lim = {"int8": 127, "int16": 32767}[kind]
        q = rng.randint(-lim, lim + 1, (K, M)).astype(kind)
    nb = -(-M // qblock) if qblock else 1
    scale = (rng.rand(K, nb) * 1e-2 + 1e-4).astype(np.float32)
    if not qblock:
        scale = scale[:, 0]
    w = rng.rand(K).astype(np.float32)
    gains = rng.rand(K).astype(np.float32)
    acc = rng.randn(M).astype(np.float32)
    return q, scale, w, gains, acc


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


GROUPS = [("int8", 0, False), ("int4", 256, True), ("int16", 256, False), ("float32", 0, True)]


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("kind,qblock,gained", GROUPS)
def test_packed_superpose_and_fold_within_tolerance_of_reference(kind, qblock, gained, fold):
    M = 4134  # not a multiple of the reference's 2048-column tile
    q, scale, w, gains, acc = _group(kind, 5, M, qblock, len(kind) + qblock)
    kw = dict(qblock=qblock, packed4=kind == "int4")
    gj, gt = (jnp.asarray(gains), _t(gains)) if gained else (None, None)
    if fold:
        got = tops.ota_fold_packed(_t(acc), _t(q), _t(scale), _t(w), gains=gt, **kw)
        want = jops.ota_fold_packed(jnp.asarray(acc), jnp.asarray(q), jnp.asarray(scale),
                                    jnp.asarray(w), gains=gj, **kw)
    else:
        got = tops.ota_dequant_superpose(_t(q), _t(scale), _t(w), gains=gt, **kw)
        want = jops.ota_dequant_superpose(jnp.asarray(q), jnp.asarray(scale), jnp.asarray(w),
                                          gains=gj, **kw)
    _close(got, want)
    # the reference's identity, exact inside the port
    sup = tops.ota_dequant_superpose(_t(q), _t(scale), _t(w), gains=gt, **kw)
    assert torch.equal(tops.ota_fold_packed(torch.zeros(M), _t(q), _t(scale), _t(w),
                                            gains=gt, **kw), sup)


def _slab(storage, n, cap, seed, D=64):
    from repro_torch.retrieval.arena import ArenaStore

    rng = np.random.RandomState(seed)
    vec = rng.randn(n, D).astype(np.float32)
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    vec[200:230] = vec[10:40]  # exact ties across record tiles
    store = ArenaStore(D, storage=storage, capacity=cap)
    store.add_batch(vec)
    qm = rng.randn(10, D).astype(np.float32)
    qm /= np.linalg.norm(qm, axis=1, keepdims=True)
    qm[:3] = vec[10:13]
    data, scales = store.raw()
    return qm, data, scales


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("storage,k", [("f32", 32), ("int8", 128), ("f32", 1)])
def test_topk_cosine_indices_bit_equal_to_reference(storage, k, use_kernel):
    qm, data, scales = _slab(storage, 400, 512, k)
    sj, ij = jops.topk_cosine(jnp.asarray(qm), jnp.asarray(data),
                              None if scales is None else jnp.asarray(scales), jnp.int32(400),
                              k=k, use_kernel=use_kernel)
    st, it = tops.topk_cosine(_t(qm), _t(data), None if scales is None else _t(scales),
                              torch.tensor(400), k=k, use_kernel=use_kernel)
    assert it.shape == (10, k) and it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)


def test_topk_cosine_keeps_the_reference_k_limit():
    qm, data, _ = _slab("f32", 300, 512, 1)
    with pytest.raises(AssertionError):
        jops.topk_cosine(jnp.asarray(qm), jnp.asarray(data), None, jnp.int32(300), k=129)
    with pytest.raises(AssertionError):
        tops.topk_cosine(_t(qm), _t(data), None, 300, k=129)


@pytest.mark.parametrize("shape,n", [((3, 7), None), ((3, 7), 7), ((2, 4134), 4133), ((5,), 3)])
def test_pack_unpack_int4_rows_bit_equal_to_reference(shape, n):
    rng = np.random.RandomState(sum(shape))
    q = rng.randint(-8, 8, shape).astype(np.int8)
    pj = np.asarray(jops.pack_int4_rows(jnp.asarray(q)))
    pt = tops.pack_int4_rows(_t(q))
    np.testing.assert_array_equal(pt.numpy(), pj)
    uj = np.asarray(jops.unpack_int4_rows(jnp.asarray(pj), n))
    ut = tops.unpack_int4_rows(pt, n)
    assert ut.dtype == torch.int8
    np.testing.assert_array_equal(ut.numpy(), uj)
    assert tops.pack_int4_rows is wire.pack_int4_rows  # one copy of the code


# ------------------------------------------------------------------ package


def test_kernels_package_exports_the_reference_names():
    names = {"fake_quant", "flash_mha", "ota_aggregate", "ota_quantize_superpose", "qmatmul",
             "quantize_weights"}
    for n in names:
        assert callable(getattr(jkernels, n)) and callable(getattr(tkernels, n))
    assert tkernels.qmatmul is tops.qmatmul and tkernels.fake_quant is tops.fake_quant


def test_kernels_package_exports_the_remaining_ops_names():
    """The reference's other ``ops`` entry names, with the same signatures'
    keywords, exported by the port's kernels package."""
    import inspect

    for n in ("ota_dequant_superpose", "ota_fold_packed", "topk_cosine", "pack_int4_rows",
              "unpack_int4_rows", "flash_mha"):
        got, want = getattr(tkernels, n), getattr(jops, n)
        assert got is getattr(tops, n)
        pj = inspect.signature(getattr(want, "__wrapped__", want)).parameters
        assert list(inspect.signature(got).parameters) == list(pj), n


_META = torch.empty((4, 8), device="meta")
_META_CALLS = {
    "fake_quant_2d": lambda m: fake_quant_2d(m, torch.ones(()), 8),
    "ota_aggregate_2d": lambda m: tops.ota_aggregate(m, torch.ones(4), torch.ones(8), 0.1),
    "qmatmul": lambda m: tops.qmatmul(m, torch.ones((8, 2), dtype=torch.int8), torch.ones(2)),
    "flash_mha": lambda m: tops.flash_mha(*(m.reshape(1, 4, 1, 8),) * 3),
    "ota_superpose": lambda m: ota_fused.ota_superpose(m, torch.ones(4), torch.ones(4)),
    "topk_cosine": lambda m: topk_similarity.topk_cosine(m, m, None, 4, k=1),
}


@pytest.mark.parametrize("name", sorted(_META_CALLS))
def test_wrappers_raise_on_a_device_with_neither_version(name):
    """Every kernel wrapper dispatches through ``_build.on_card``: CUDA
    launches, CPU runs the plain version, any other device raises."""
    with pytest.raises(ValueError, match="no kernel or plain version"):
        _build.on_card(_META)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        _META_CALLS[name](_META)


def test_fake_quant_plain_keeps_nan_and_clips():
    x = torch.tensor([float("nan"), 1e9, -1e9, 0.26, 0.25], dtype=torch.float32)
    out = fake_quant_plain(x, torch.tensor(0.5), 4)
    assert math.isnan(out[0]) and out[1:].tolist() == [3.5, -3.5, 0.5, 0.0]
