"""Parity of the port's hybrid family (zamba2, ``models/hybrid.py``) with
the JAX reference, on the CPU: prefill (with the chunked attention and
with the flash kernel's plain version, the reference's Pallas kernel in
interpret mode), decode, prefill + decode against the full forward, the
loss and its gradients with remat on and off, ``ServeEngine`` and
``launch/serve.py``; at ``zamba2-2.7b``'s reduced widths (2 segments of
1 layer) and with ``n_layers=4, attn_every=2`` (2 segments of 2: the
stacked inner axis).

JAX params cross through ``convert.py``. Tolerances as
``tests/test_torch_ssm.py``: logits rtol/atol 1e-4, states and caches
1e-5, prefill + decode 2e-3 in log-softmax, the loss rtol 1e-5,
gradients rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models.registry import build_model as jbuild
from repro_torch.configs import get_arch as tget_arch
from repro_torch.launch import serve as tserve
from repro_torch.models import hybrid as tHY
from repro_torch.models.registry import build_model as tbuild
from test_torch_ssm import (LOGIT_TOL, STATE_TOL, _models, _np, engine_vs_reference,
                            loss_and_grads_vs_reference, port_value_and_grad,
                            prefill_decode_vs_forward, serve_cli, slot_isolation)

ARCH = "zamba2-2.7b"
# reduced() gives attn_every 1 (every = 1); 4 layers of attn_every 2 stack
# two layers a segment
SHAPES = [dict(), dict(n_layers=4, attn_every=2)]


def _close_cache(tc, jc):
    assert set(tc) == set(jc)
    for n in tc:
        assert tc[n].shape == jc[n].shape, n
        if n == "pos":
            np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))
        else:
            np.testing.assert_allclose(_np(tc[n]), _np(jc[n]), **STATE_TOL)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("kw", SHAPES, ids=["reduced", "4x2"])
def test_prefill_and_decode_equal_the_reference(kw, flash):
    """Prefill (logits, SSM states, conv tails, the shared block's K/V at
    each segment), grow the cache, 6 decode steps on the reference's
    greedy tokens."""
    jm, tm, jp, tp = _models(ARCH, use_flash_kernel=flash, attn_chunk=16, **kw)
    n_seg, every = tHY._segments(tm.cfg)
    assert (n_seg, every) == ((2, 1) if not kw else (2, 2))
    B, P, gen = 2, 40 if not flash else 24, 6
    toks = np.random.RandomState(7).randint(0, jm.cfg.vocab_size, (B, P)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _close_cache(tc, jc)
    jc, tc = jm.grow_cache(jc, P + gen), tm.grow_cache(tc, P + gen)
    assert tc["k"].shape[2] == P + gen and tc["ssm_h"].shape == jc["ssm_h"].shape
    jdec = jax.jit(jm.decode)
    for s in range(gen):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32).reshape(B, 1)
        pos = np.full((B,), P + s, np.int32)
        jl, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos)})
        tl, tc = tm.decode(tp, tc, {"tokens": torch.from_numpy(tok),
                                    "pos": torch.from_numpy(pos)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _close_cache(tc, jc)


def test_model_api_matches_reference():
    """``cache_len_for`` (the shared block's KV: the sequence length),
    ``init_cache`` and the reduced config's segment layout."""
    jm, tm, _, _ = _models(ARCH)
    for n in (16, 32_768, 40_000):
        assert tm.cache_len_for(n) == jm.cache_len_for(n)
        assert tm.decode_window_for(n) == jm.decode_window_for(n)
    _close_cache(tm.init_cache(3, 10, "cpu"), jm.init_cache(3, 10))
    assert tm.cfg.attn_every == jm.cfg.attn_every == 1 and tm.cfg.n_layers == 2


@pytest.mark.parametrize("kw", SHAPES, ids=["reduced", "4x2"])
def test_prefill_decode_equals_full_forward(kw):
    prefill_decode_vs_forward(ARCH, **kw)


def test_prefill_bf16_equals_the_reference():
    """bf16 params and compute: logits within 3% of their largest
    magnitude; the SSM states f32, the conv tails and K/V bf16."""
    jm, tm, jp, tp = _models(ARCH, param_dtype="bfloat16", compute_dtype="bfloat16")
    toks = np.random.RandomState(8).randint(0, jm.cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tc["ssm_h"].dtype == torch.float32
    assert tc["ssm_conv"].dtype == tc["k"].dtype == torch.bfloat16
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=0.03 * np.abs(jl).max())


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("kw", SHAPES, ids=["reduced", "4x2"])
def test_loss_and_grads_equal_the_reference(kw, remat):
    loss_and_grads_vs_reference(ARCH, remat, attn_chunk=16, **kw)


def test_remat_changes_no_gradient():
    """remat wraps the Mamba-2 layers in ``checkpoint``: the loss and every
    gradient are the same bit for bit with it on and off."""
    _, tm, _, tp = _models(ARCH, **SHAPES[1])
    b = {"tokens": torch.from_numpy(np.random.RandomState(3).randint(0, 512, (2, 20)).astype(
        np.int32))}
    runs = [port_value_and_grad(tbuild(tm.cfg.with_(remat=remat)), tp, b)
            for remat in (False, True)]
    assert float(runs[0][0]) == float(runs[1][0])
    for a, g in zip(runs[0][2], runs[1][2]):
        assert torch.equal(a, g)


def test_engine_matches_reference():
    engine_vs_reference(ARCH)


def test_engine_slot_reset_isolates_requests():
    slot_isolation(ARCH)


def test_launch_serve_matches_reference_flow():
    jm, _, jp, tp = _models(ARCH)
    res = tserve.serve(tget_arch(ARCH).reduced(), batch=2, prompt_len=16, gen=4, seed=3,
                       device="cpu", params=tp)
    jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(res.prompts.astype(np.int32))})
    np.testing.assert_allclose(res.prefill_logits.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert res.tokens.shape == (2, 4) and res.all_finite
    assert res.cache["k"].shape[2] == 16 + 4 and res.cache["ssm_h"].shape[:3] == (2, 1, 2)


def test_serve_cli_on_cpu():
    serve_cli(ARCH)


def test_reference_config_fields_are_equal():
    """Every field the port's config shares with the reference's, for both
    families, full and reduced."""
    for name in ("falcon-mamba-7b", ARCH):
        for j, t in ((jget_arch(name), tget_arch(name)),
                     (jget_arch(name).reduced(), tget_arch(name).reduced())):
            for f in t.__dataclass_fields__:
                assert getattr(t, f) == getattr(j, f), (name, f)
            assert (t.resolved_d_inner(), t.resolved_ssm_heads(), t.resolved_dt_rank()) == (
                j.resolved_d_inner(), j.resolved_ssm_heads(), j.resolved_dt_rank())
    assert jbuild(jget_arch(ARCH).reduced()).cfg.family == "hybrid"
