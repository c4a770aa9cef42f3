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

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops as tops

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
    part-filled column blocks); float32 the scalar kernel."""
    want = "flash_fwd_f32" if dtype == torch.float32 else "flash_fwd_hopper"
    assert kfa.kernel_design(dtype, D) == want
    assert want in kfa.DESIGNS


@pytest.mark.parametrize("D,want", [(1, "flash_fwd_hopper"), (40, "flash_fwd_hopper"),
                                    (65, "flash_fwd_hopper"), (100, "flash_fwd_hopper"),
                                    (120, "flash_fwd_hopper")])
def test_kernel_design_follows_the_padded_width(D, want):
    """Padded widths (1 -> 32, 40 -> 64, 65 -> 80, 100 -> 112, 120 -> 128)
    run the Hopper kernel too."""
    assert kfa.kernel_design(torch.bfloat16, D) == want


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.bfloat16, 192),
                                     (torch.float32, 0)])
def test_kernel_design_rejects_what_no_kernel_takes(dtype, D):
    with pytest.raises(ValueError):
        kfa.kernel_design(dtype, D)
