"""Parity of the port's flash attention entry point
(``repro_torch.kernels.ops.flash_mha(q, k, v, *, causal=...)``) with the JAX
package's ``repro.kernels.ops.flash_mha``, on the CPU.

The same numpy inputs (fixed seeds) go through both. The reference runs as
its own tests run it on the CPU: the jitted entry point with the Pallas
kernel in interpret mode. The port runs the kernel's plain version here (CPU
tensors); ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` hold the
CUDA kernel against the same plain version on the card.

Cases: the reference's own three causal cases (``tests/test_kernels.py``),
then Sq != Sk with and without the causal mask (top-left: row i sees keys
j <= i), the head widths of the repository's configs (80: zamba2-2.7b, 112:
kimi-k2-1t-a32b) and a width the kernel does not instantiate (40, which the
card zero-pads to 64). f32 is held to rtol/atol 1e-5 (summation order only),
bf16 to ``flash_attention.mismatch``'s per-element rule. Inputs outside the
reference's padding precondition raise ``ValueError``. The route table
(``kernel_design``: which CUDA kernel each dtype and head width runs) is a
pure function, held here; ``chip_smoke.py`` holds the C launcher to it.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels.qmatmul import split3_plain

# the plain model of f32 attention on the tensor cores' bf16 plane products
# lives beside the probe that reads its planted faults on the card
_PROBE = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "flash_tolerance_probe.py"
_spec = importlib.util.spec_from_file_location("flash_tolerance_probe", _PROBE)
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, Sq, Sk, H, KV, D, causal)
CASES = [
    (2, 128, 128, 4, 4, 64, True),  # the reference's: MHA, tile-aligned
    (1, 256, 256, 4, 2, 32, True),  # GQA
    (2, 200, 200, 2, 1, 64, True),  # MQA, ragged length
    (1, 128, 256, 4, 2, 32, False),  # Sq < Sk, no mask
    (1, 256, 128, 2, 1, 80, True),  # Sq > Sk: rows past Sk see every key
    (1, 128, 256, 2, 2, 112, True),  # Sq < Sk, causal
    (1, 200, 256, 2, 1, 64, False),  # ragged Sq, no mask
    (1, 256, 256, 2, 2, 40, True),  # a width the kernel pads
    (1, 100, 200, 2, 1, 32, True),  # unaligned Sk, causal with Sq <= Sk: padding unseen
]


def _qkv(seed, B, Sq, Sk, H, KV, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32),
            rng.randn(B, Sk, KV, D).astype(np.float32),
            rng.randn(B, Sk, KV, D).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal", CASES)
def test_flash_mha_matches_the_reference(B, Sq, Sk, H, KV, D, causal):
    q, k, v = _qkv(B + Sq + 3 * Sk + D, B, Sq, Sk, H, KV, D)
    got = tops.flash_mha(_t(q), _t(k), _t(v), causal=causal)
    want = np.asarray(jops.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal))
    assert got.shape == (B, Sq, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_mha_bf16_within_the_kernel_rule_of_the_reference():
    """bf16, no mask, Sq != Sk: the port's plain version against the
    reference's Pallas kernel, under the rule that holds the CUDA kernel to
    the plain version."""
    q, k, v = _qkv(21, 1, 256, 384, 4, 2, 64)
    bf = lambda a: a.astype(ml_dtypes.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(bf(a).view(np.int16)).view(torch.bfloat16)  # noqa: E731
    want = np.asarray(jops.flash_mha(*(jnp.asarray(bf(a)) for a in (q, k, v)), causal=False))
    got = tops.flash_mha(tb(q), tb(k), tb(v), causal=False)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 256, 4, 64)
    mm = kfa.mismatch(got, torch.from_numpy(np.array(want.view(np.int16))).view(torch.bfloat16))
    assert mm["within"], mm


def test_causal_rows_past_sk_see_every_key():
    """Top-left alignment: with Sq > Sk and the causal mask, a row at or past
    Sk equals the row of the same query without the mask."""
    q, k, v = map(_t, _qkv(5, 1, 256, 128, 2, 2, 32))
    causal = tops.flash_mha(q, k, v, causal=True)
    full = tops.flash_mha(q, k, v, causal=False)
    assert torch.equal(causal[:, 128:], full[:, 128:])
    assert not torch.equal(causal[:, :127], full[:, :127])


@pytest.mark.parametrize("Sq,Sk,causal", [(128, 200, False), (256, 200, True), (64, 100, False)])
def test_flash_mha_raises_where_the_reference_sees_its_padding(Sq, Sk, causal):
    """Sk not a multiple of 128, with no mask or with Sq > Sk: some real row
    of the reference would attend to its zero-padded keys."""
    q, k, v = map(_t, _qkv(9, 1, Sq, Sk, 2, 1, 32))
    with pytest.raises(ValueError, match="tile-aligned Sk"):
        tops.flash_mha(q, k, v, causal=causal)


@pytest.mark.parametrize("D,want", [(1, 32), (32, 32), (40, 64), (65, 80), (100, 112),
                                    (128, 128)])
def test_kernel_head_dim_is_the_next_instantiated_width(D, want):
    assert kfa.kernel_head_dim(D) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", kfa.HEAD_DIMS)
def test_kernel_design_routes_every_instantiated_width(dtype, D):
    """bf16 at every width runs the Hopper kernel (D 32, 80, 96 and 112 in
    part-filled column blocks); float32 at every width the TMA-fed f32
    kernel."""
    want = "flash_fwd_f32_hopper" if dtype == torch.float32 else "flash_fwd_hopper"
    assert kfa.kernel_design(dtype, D) == want
    assert want in kfa.DESIGNS


@pytest.mark.parametrize("D,want", [(1, "flash_fwd_hopper"), (40, "flash_fwd_hopper"),
                                    (65, "flash_fwd_hopper"), (100, "flash_fwd_hopper"),
                                    (120, "flash_fwd_hopper")])
def test_kernel_design_follows_the_padded_width(D, want):
    """Padded widths (1 -> 32, 40 -> 64, 65 -> 80, 100 -> 112, 120 -> 128)
    run the Hopper kernel too, and in float32 the f32 kernel."""
    assert kfa.kernel_design(torch.bfloat16, D) == want
    assert kfa.kernel_design(torch.float32, D) == "flash_fwd_f32_hopper"


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.bfloat16, 192),
                                     (torch.float32, 0)])
def test_kernel_design_rejects_what_no_kernel_takes(dtype, D):
    with pytest.raises(ValueError):
        kfa.kernel_design(dtype, D)


# the exact split that puts f32 on the tensor cores (row 6's f32 route; the
# tensor-core model of row 7's): q, k, v as a model gives them, p in [0, 1],
# and the edges (subnormals, the largest finite, +-inf, NaN, signed zeros)
SPLIT_EDGES = np.array([0.0, -0.0, 1.0, -1.0, 2.0**-126, 2.0**-149, 3 * 2.0**-140, -(2.0**-130),
                        2.0**-110, 2.0**-100, 3.4028235e38, -3.4028235e38, np.inf, -np.inf,
                        np.nan, 1 - 2.0**-24, 2.0**-24, 0.1, 1 / 3], dtype=np.float32)


def _split_sum(x):
    hi, mid, lo = split3_plain(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    return hi.double() + mid.double() + lo.double(), (hi, mid, lo)


@pytest.mark.parametrize("what", ["q", "k", "v", "p"])
def test_split3_is_exact_on_attention_operands(what):
    """hi + mid + lo == x exactly (in f64) for q, k, v draws and p in [0, 1]:
    every bit of x is in one plane; |mid| < 2**-7 |x| and |lo| < 2**-14
    |x|, the bounds the dropped pairs are reckoned from."""
    rng = np.random.RandomState({"q": 1, "k": 2, "v": 3, "p": 4}[what])
    if what == "p":  # p = exp(s - m): (0, 1], many tiny
        x = np.exp(-rng.exponential(8.0, 20000)).astype(np.float32)
    else:
        x = (rng.randn(20000) * 10.0 ** rng.uniform(-6, 3, 20000)).astype(np.float32)
    t = torch.from_numpy(x)
    total, (hi, mid, lo) = _split_sum(t)
    assert torch.equal(total, t.double())
    assert bool((mid.double().abs() < 2.0**-7 * t.double().abs()).all())
    assert bool((lo.double().abs() < 2.0**-14 * t.double().abs()).all())


def test_split3_keeps_the_edges():
    """Exact from the largest finite down to subnormals that are multiples
    of 2**-133 (bf16's smallest); an f32 subnormal's bits under 2**-133
    cannot be in any bf16 and are dropped (a p that small moves no output).
    A non-finite x is hi alone (inf keeps its sign, NaN stays NaN) with mid
    = lo = 0."""
    t = torch.from_numpy(SPLIT_EDGES)
    total, (hi, mid, lo) = _split_sum(t)
    fin = torch.isfinite(t)
    on_grid = fin & (torch.remainder(t.double(), 2.0**-133) == 0)
    assert int(on_grid.sum()) == len(SPLIT_EDGES) - 5  # all but 2**-149, 3 2**-140, inf, nan
    assert torch.equal(total[on_grid], t.double()[on_grid])
    assert bool(((total - t.double()).abs()[fin] < 2.0**-133).all())
    inf = torch.isinf(t)
    assert torch.equal(hi[inf].float(), t[inf])
    assert bool(torch.isnan(hi[torch.isnan(t)]).all())
    assert not bool(mid[~fin].any()) and not bool(lo[~fin].any())


# (B, Sq, Sk, H, KV, D, causal): causal, non-causal, GQA
SPLIT3_CASES = [(1, 256, 256, 4, 4, 64, True), (2, 128, 384, 4, 4, 32, False),
                (1, 300, 300, 8, 2, 128, True)]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal", SPLIT3_CASES)
def test_split3_model_is_within_the_f32_rule(B, Sq, Sk, H, KV, D, causal):
    """The tensor-core model (scores as the plain version's, PV as the six
    plane pairs, small first) is within mismatch's f32 rule of the plain
    version at small shapes."""
    q, k, v = map(_t, _qkv(B + Sq + Sk + D, B, Sq, Sk, H, KV, D))
    plain = kfa.flash_attention_plain(q, k, v, causal=causal)
    model = probe.split3_attention(q, k, v, causal=causal)
    assert model.shape == plain.shape and model.dtype == torch.float32
    mm = kfa.mismatch(model, plain)
    assert mm["within"], mm


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal", SPLIT3_CASES)
def test_split3_model_with_the_hi_plane_alone_is_outside_the_rule(B, Sq, Sk, H, KV, D, causal):
    """One bf16 pass (p's and v's hi planes alone) is far outside the f32
    rule: the check sees a kernel that drops the lower planes."""
    q, k, v = map(_t, _qkv(B + Sq + Sk + D, B, Sq, Sk, H, KV, D))
    plain = kfa.flash_attention_plain(q, k, v, causal=causal)
    one = probe.split3_attention(q, k, v, causal=causal, pairs=((0, 0),))
    mm = kfa.mismatch(one, plain)
    assert not mm["within"] and mm["over_element_bound"] > 0.1 * one.numel(), mm


def _moved(n, k, D, dtype=torch.bfloat16, seed=11):
    """A plain output of n elements as (1, S, 8 heads, D) and a copy with its
    first k elements one ulp away (within the element bound)."""
    plain = torch.from_numpy(np.random.RandomState(seed).randn(n).astype(np.float32)).to(dtype)
    out = plain.float().clone()
    out[:k] += kfa.ulp(out[:k], dtype)
    return out.to(dtype).view(1, -1, 8, D), plain.view(1, -1, 8, D)


@pytest.mark.parametrize("D", kfa.HEAD_DIMS)
@pytest.mark.parametrize("moved,within", [("three", True), ("floor", True), ("past", False)])
def test_mismatch_reads_a_small_output_by_its_floor(D, moved, within):
    """One query row over 8 heads at width D (8 D elements, the card's small
    cases): 1% is under one moved row, so the floor small_floor(D) =
    TOL_N0 D lets that many one-ulp flips through (3 at the card test's
    draw of PR 34), and no more."""
    n0 = kfa.small_floor(torch.bfloat16, D)
    k = {"three": 3, "floor": n0, "past": n0 + 1}[moved]
    out, plain = _moved(8 * D, k, D)
    mm = kfa.mismatch(out, plain)
    assert mm["differing"] == k and mm["over_element_bound"] == 0
    assert mm["within"] is within


@pytest.mark.parametrize("n", [256, 2**20])
def test_mismatch_fails_a_planted_share_on_small_and_large_outputs(n):
    """13% of the elements one ulp off (the smallest share a planted bf16
    fault has changed in the probe's readings: 35 of 256 at D 32) fails at
    256 elements and at 2**20, where the 1% share governs as before."""
    D = 32 if n == 256 else 128
    out, plain = _moved(n, int(0.13 * n), D)
    mm = kfa.mismatch(out, plain)
    assert mm["over_element_bound"] == 0 and not mm["within"]
    if n > kfa.small_floor(torch.bfloat16, D) / kfa.TOL_SHARE[torch.bfloat16]:
        ok, plain = _moved(n, int(0.009 * n), D)
        assert kfa.mismatch(ok, plain)["within"]
