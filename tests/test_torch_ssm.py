"""Parity of the port's state-space blocks (``models/ssm.py``) and of the
ssm family (falcon-mamba, ``models/transformer.py``'s ssm branch) with the
JAX reference, on the CPU.

The same numpy inputs go through ``jax.jit`` of the reference and the
port; JAX params cross through ``convert.py``, so they are equal bit for
bit. Tolerances:

- the convs and scans, the blocks and decode steps in f32 rtol 1e-4 /
  atol 1e-5: the chunked scans are the reference's passes in the same
  order, but the per-step products contract over N and the SSD's over L
  and N in another summation order (a probe at T 130, d 16, N 8 read
  max |dy| 1.5e-6, 19% of outputs equal bit for bit). The scans' plain
  versions (step-by-step recurrences) are held to the chunked scans at
  the reference tests' own rtol/atol 1e-4;
- whole-model logits rtol/atol 1e-4 and states 1e-5 (as
  ``tests/test_torch_serve.py``); prefill + decode against the full
  forward at the reference's own log-softmax rtol/atol 2e-3;
- the loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6 (as
  ``tests/test_torch_train.py``);
- ``init_mamba1``'s deterministic ``A_log`` within 1 ulp: ``jnp.log`` and
  ``torch.log`` differ in the last bit at 7, 47 and 49.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import ssm as jS
from repro.models.registry import build_model as jbuild
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.launch import serve as tserve
from repro_torch.models import ssm as tS
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

F32_TOL = dict(rtol=1e-4, atol=1e-5)
ORACLE_TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ARCH = "falcon-mamba-7b"

# (B, T, chunk): the reference tests' shapes at chunk 8; T 130 at the
# default chunk 64 (padding, three chunks); T 2 < K - 1 (one short chunk)
SCAN_CASES = [(2, 37, 8), (2, 130, 64), (2, 2, 64)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _cfgs(name, **kw):
    return jget_arch(name).reduced().with_(**kw), tget_arch(name).reduced().with_(**kw)


def _models(name, seed=0, **kw):
    jcfg, tcfg = _cfgs(name, **kw)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, tm, jp, convert.params_from_numpy(jp, "cpu")


# ---------------------------------------------------------------- convs


@pytest.mark.parametrize("B,T,_", SCAN_CASES)
def test_causal_conv1d_equals_the_reference(B, T, _):
    rng = np.random.RandomState(T)
    x, w, b = rng.randn(B, T, 24), rng.randn(4, 24), rng.randn(24)
    x, w, b = (a.astype(np.float32) for a in (x, w, b))
    want = jax.jit(jS.causal_conv1d)(x, w, b)
    got = tS.causal_conv1d(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_conv1d_decode_equals_the_reference():
    rng = np.random.RandomState(1)
    x_t, st, w, b = (rng.randn(*s).astype(np.float32)
                     for s in ((3, 24), (3, 3, 24), (4, 24), (24,)))
    want = jax.jit(jS.conv1d_decode)(x_t, st, w, b)
    got = tS.conv1d_decode(_t(x_t), _t(st), _t(w), _t(b))
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **F32_TOL)


@pytest.mark.parametrize("T", [2, 9])
def test_conv_decode_continues_the_prefill_conv(T):
    """The conv tail the block hands to decode (the last K - 1 pre-conv
    inputs, left-padded when T < K - 1) makes the one-step conv equal the
    full conv at the next position."""
    rng = np.random.RandomState(T)
    x = _t(rng.randn(2, T + 1, 8).astype(np.float32))
    w, b = _t(rng.randn(4, 8).astype(np.float32)), _t(rng.randn(8).astype(np.float32))
    full = tS.causal_conv1d(x, w, b)
    tail = tS._conv_tail(x[:, :T], 4)
    assert tail.shape == (2, 3, 8)
    # its own storage: a view would keep the block's whole input alive
    assert tail.untyped_storage().nbytes() == tail.numel() * tail.element_size()
    if T < 3:
        assert torch.equal(tail[:, :3 - T], torch.zeros(2, 3 - T, 8))
    out, nxt = tS.conv1d_decode(x[:, T], tail, w, b)
    np.testing.assert_allclose(out.numpy(), full[:, T].numpy(), **F32_TOL)
    assert torch.equal(nxt, tS._conv_tail(x, 4))


# ---------------------------------------------------------------- scans


def _mamba1_inputs(B, T, d=8, N=4, seed=0):
    rng = np.random.RandomState(seed + T)
    dt = (np.abs(rng.randn(B, T, d)) * 0.1).astype(np.float32)
    A = -(np.abs(rng.randn(d, N)) + 0.1).astype(np.float32)
    Bm, Cm = rng.randn(B, T, N).astype(np.float32), rng.randn(B, T, N).astype(np.float32)
    x = rng.randn(B, T, d).astype(np.float32)
    h0 = (rng.randn(B, d, N) * 0.5).astype(np.float32)
    return dt, A, Bm, Cm, x, h0


def _ssd_inputs(B, T, H=3, P=4, N=5, seed=1):
    rng = np.random.RandomState(seed + T)
    x = rng.randn(B, T, H, P).astype(np.float32)
    dt = (np.abs(rng.randn(B, T, H)) * 0.2).astype(np.float32)
    A = -(np.abs(rng.randn(H)) + 0.2).astype(np.float32)
    Bm, Cm = rng.randn(B, T, N).astype(np.float32), rng.randn(B, T, N).astype(np.float32)
    h0 = (rng.randn(B, H, P, N) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("B,T,chunk", SCAN_CASES)
def test_mamba1_chunked_scan_equals_the_reference(B, T, chunk):
    args = _mamba1_inputs(B, T)
    want = jax.jit(jS._mamba1_chunked_scan, static_argnames="chunk")(*args, chunk=chunk)
    got = tS._mamba1_chunked_scan(*map(_t, args), chunk=chunk)
    for a, e in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **F32_TOL)
    plain = tS.mamba1_scan_plain(*map(_t, args))
    for a, e in zip(plain, got):
        np.testing.assert_allclose(a.numpy(), e.numpy(), **ORACLE_TOL)


@pytest.mark.parametrize("B,T,chunk", SCAN_CASES)
def test_ssd_scan_equals_the_reference(B, T, chunk):
    args = _ssd_inputs(B, T)
    want = jax.jit(jS._ssd_scan, static_argnames="chunk")(*args, chunk=chunk)
    got = tS._ssd_scan(*map(_t, args), chunk=chunk)
    for a, e in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **F32_TOL)
    plain = tS.ssd_scan_plain(*map(_t, args))
    for a, e in zip(plain, got):
        np.testing.assert_allclose(a.numpy(), e.numpy(), **ORACLE_TOL)


def test_ssd_scan_gradient_is_finite_with_steep_decay():
    """Above the diagonal the segment sums are positive; with large dt A
    their exp overflows. The exponent is masked before exp, so the
    backward carries no inf * 0."""
    x, dt, A, Bm, Cm, h0 = map(_t, _ssd_inputs(1, 64))
    dt = (dt * 400).requires_grad_(True)
    y, h = tS._ssd_scan(x, dt, A, Bm, Cm, h0)
    assert torch.isfinite(y).all()
    (g,) = torch.autograd.grad(y.square().sum() + h.sum(), dt)
    assert torch.isfinite(g).all()


# ---------------------------------------------------------------- blocks


def _block_inputs(name, T, seed=3, **kw):
    jcfg, tcfg = _cfgs(name, **kw)
    init = jS.init_mamba1 if jcfg.family == "ssm" else jS.init_mamba2
    jp = jax.tree.map(np.asarray, init(jax.random.key(seed), jcfg, jnp.float32))
    x = np.random.RandomState(seed + T).randn(2, T, jcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jp, convert.params_from_numpy(jp, "cpu"), x


@pytest.mark.parametrize("T", [2, 37, 130])
def test_mamba1_block_equals_the_reference(T):
    jcfg, tcfg, jp, tp, x = _block_inputs(ARCH, T)
    want = jax.jit(lambda p, x: jS.mamba1_block(p, x, jcfg))(jp, x)
    got = tS.mamba1_block(tp, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("T", [2, 37, 130])
def test_mamba2_block_with_state_equals_the_reference(T):
    jcfg, tcfg, jp, tp, x = _block_inputs("zamba2-2.7b", T)
    want_out, want_st = jax.jit(lambda p, x: jS.mamba2_block(p, x, jcfg, return_state=True))(
        jp, x)
    got_out, got_st = tS.mamba2_block(tp, _t(x), tcfg, return_state=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **F32_TOL)
    for n in ("h", "conv"):
        assert got_st[n].shape == want_st[n].shape
        np.testing.assert_allclose(got_st[n].numpy(), np.asarray(want_st[n]), **F32_TOL)
    assert tS.mamba2_block(tp, _t(x), tcfg)[1] is None


def _state(rng, shapes):
    return {n: (rng.randn(*s) * 0.5).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("name", [ARCH, "zamba2-2.7b"])
def test_decode_steps_equal_the_reference(name):
    """Three steps of ``mamba1_decode`` / ``mamba2_decode`` from a random
    state, each fed the reference's state after the step before."""
    jcfg, tcfg, jp, tp, _ = _block_inputs(name, 1)
    rng = np.random.RandomState(4)
    di, N, K = jcfg.resolved_d_inner(), jcfg.ssm_state, jcfg.ssm_conv
    if jcfg.family == "ssm":
        fj, ft = jS.mamba1_decode, tS.mamba1_decode
        st = _state(rng, {"h": (2, di, N), "conv": (2, K - 1, di)})
    else:
        H = jcfg.resolved_ssm_heads()
        fj, ft = jS.mamba2_decode, tS.mamba2_decode
        st = _state(rng, {"h": (2, H, di // H, N), "conv": (2, K - 1, di + 2 * N)})
    step = jax.jit(lambda p, x, s: fj(p, x, jcfg, s))
    for _ in range(3):
        x = rng.randn(2, 1, jcfg.d_model).astype(np.float32)
        want, want_st = step(jp, x, st)
        got, got_st = ft(tp, _t(x), tcfg, {n: _t(a) for n, a in st.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        for n in st:
            np.testing.assert_allclose(got_st[n].numpy(), np.asarray(want_st[n]), **F32_TOL)
        st = jax.tree.map(np.asarray, want_st)


# ---------------------------------------------------------------- init


def _tree_matches(want, got):
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = tree_flatten(got)[0]
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
    return sum(b.numel() for b in tl), sum(b.numel() * b.element_size() for b in tl)


@pytest.mark.parametrize("name,n_params,n_bytes", [
    (ARCH, 7_272_665_088, 14_564_204_544),
    ("zamba2-2.7b", 2_435_777_440, 4_871_580_800),
])
def test_full_width_param_tree_equals_the_reference(name, n_params, n_bytes):
    """Leaf names, shapes and dtypes at full width and depth against
    ``jax.eval_shape`` of the reference's init (the port's on meta tensors):
    ``A_log``, ``D`` and ``dt_bias`` f32 under bf16 params."""
    want = jax.eval_shape(lambda: jbuild(jget_arch(name)).init(jax.random.key(0)))
    got = tbuild(tget_arch(name)).init(None, torch.device("meta"))
    assert _tree_matches(want, got) == (n_params, n_bytes)
    stack = got["layers"] if name == ARCH else got["segments"]
    for leaf in ("A_log", "D", "dt_bias"):
        assert stack["mamba"][leaf].dtype == torch.float32
    assert stack["mamba"]["in_proj"].dtype == torch.bfloat16


def test_init_mamba1_draws_and_a_log():
    """A small init on the CPU: ``A_log`` within 1 ulp of the reference's
    log(1..N) on every channel, the step-size bias inside softplus^-1 of
    [1e-3, 0.1], D ones, the conv bias zeros."""
    cfg = tget_arch(ARCH).with_(d_model=64, ssm_state=64, n_layers=2, vocab_size=64)
    p = tbuild(cfg).init(torch.Generator().manual_seed(0), "cpu")["layers"]["mamba"]
    want = np.asarray(jS.init_mamba1(jax.random.key(0), jget_arch(ARCH).with_(
        d_model=64, ssm_state=64), jnp.bfloat16)["A_log"])
    for layer in range(2):
        np.testing.assert_array_max_ulp(p["A_log"][layer].numpy(), want, maxulp=1)
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert torch.equal(p["D"], torch.ones_like(p["D"]))
    assert not p["conv_b"].any() and p["conv_w"].dtype == torch.bfloat16


# ---------------------------------------------------------------- the LM


def _close_state(tc, jc):
    assert set(tc) == set(jc)
    for n in tc:
        assert tc[n].dtype == torch.float32 or n != "h"
        np.testing.assert_allclose(_np(tc[n]), _np(jc[n]), **STATE_TOL)


@pytest.mark.parametrize("P", [2, 40])
def test_prefill_and_decode_equal_the_reference(P):
    """Prefill (logits, final states and conv tails), then 6 decode steps
    on the reference's greedy tokens; the ssm cache does not grow."""
    jm, tm, jp, tp = _models(ARCH)
    B, gen = 2, 6
    toks = np.random.RandomState(7).randint(0, jm.cfg.vocab_size, (B, P)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _close_state(tc, jc)
    assert tc["conv"].shape == (2, B, 3, jm.cfg.resolved_d_inner())
    jdec = jax.jit(jm.decode)
    for s in range(gen):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32).reshape(B, 1)
        pos = np.full((B,), P + s, np.int32)
        jl, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos)})
        tl, tc = tm.decode(tp, tc, {"tokens": torch.from_numpy(tok),
                                    "pos": torch.from_numpy(pos)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _close_state(tc, jc)


def test_model_api_matches_reference():
    """``cache_len_for`` (0 for ssm: a fixed-size state), ``init_cache``
    and ``grow_cache`` (an ssm cache comes back unchanged)."""
    jm, tm, _, _ = _models(ARCH)
    for n in (16, 32_768, 40_000):
        assert tm.cache_len_for(n) == jm.cache_len_for(n) == 0
        assert tm.decode_window_for(n) == jm.decode_window_for(n)
    jc, tc = jm.init_cache(3, 10), tm.init_cache(3, 10, "cpu")
    _close_state(tc, jc)
    assert tm.grow_cache(tc, 50) == tc


def prefill_decode_vs_forward(arch, **kw):
    """The reference's test: prefill on S tokens then decode token S gives
    the full forward's next-token log-softmax within rtol/atol 2e-3."""
    jm, tm, jp, tp = _models(arch, **kw)
    B, S_ = 2, 24
    tokens = np.random.RandomState(5).randint(0, jm.cfg.vocab_size, (B, S_ + 1)).astype(
        np.int32)
    if jm.cfg.family == "hybrid":
        from repro.models.hybrid import _forward

        x, _ = jax.jit(lambda p, t: _forward(p, t, jm.cfg, collect_state=False))(jp, tokens)
        want = (x[:, -1] @ jp["lm_head"]).astype(jnp.float32)
    else:
        from repro.models.transformer import lm_logits_and_aux

        x, head, _ = jax.jit(lambda p, b: lm_logits_and_aux(p, b, jm.cfg))(
            jp, {"tokens": tokens})
        want = (x[:, -1] @ head).astype(jnp.float32)
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :S_])})
    if jm.cfg.family != "ssm":
        cache = tm.grow_cache(cache, S_ + 1)
    got, _ = tm.decode(tp, cache, {"tokens": torch.from_numpy(tokens[:, S_:]),
                                   "pos": torch.full((B,), S_, dtype=torch.int32)})
    np.testing.assert_allclose(torch.log_softmax(got, -1).numpy(),
                               np.asarray(jax.nn.log_softmax(want)), rtol=2e-3, atol=2e-3)


def test_prefill_decode_equals_full_forward():
    prefill_decode_vs_forward(ARCH)


def test_prefill_bf16_equals_the_reference():
    """bf16 params and compute: logits within 3% of their largest
    magnitude (bf16 keeps 8 bits; the packages round the products and the
    silu at different points); the states f32, the conv tails bf16."""
    jm, tm, jp, tp = _models(ARCH, param_dtype="bfloat16", compute_dtype="bfloat16")
    toks = np.random.RandomState(8).randint(0, jm.cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tc["h"].dtype == torch.float32 and tc["conv"].dtype == torch.bfloat16
    assert tp["layers"]["mamba"]["A_log"].dtype == torch.float32
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=0.03 * np.abs(jl).max())


# ---------------------------------------------------------------- loss


def port_value_and_grad(tm, tp, batch):
    leaves, structure = tree_flatten(tp)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss, metrics = tm.loss(tree_unflatten(structure, live), batch)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, list(torch.autograd.grad(loss, live))


def loss_and_grads_vs_reference(arch, remat, **kw):
    jm, tm, jp, tp = _models(arch, remat=remat, **kw)
    b = {"tokens": np.random.RandomState(11).randint(0, jm.cfg.vocab_size, (2, 40)).astype(
        np.int32)}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, b))
    tl, tmet, tg = port_value_and_grad(tm, tp, {k: _t(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]), rtol=1e-5)
    jg = jax.tree.leaves(jg)
    assert len(tg) == len(jg)
    for a, g in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), **GRAD_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads_equal_the_reference(remat):
    loss_and_grads_vs_reference(ARCH, remat, loss_chunk=7)


# ---------------------------------------------------------------- serving


def requests(cls, n, seed=0, vocab=512):
    rng = np.random.RandomState(seed)
    return [cls(i, rng.randint(0, vocab, size=rng.randint(4, 12)).astype(np.int32),
                max_new_tokens=int(rng.randint(4, 16)))
            for i in range(n)]


def capture(eng):
    """Record every decode call's logits (as f32 numpy)."""
    logs, inner = [], eng._decode

    def wrapped(p, c, b):
        logits, cache = inner(p, c, b)
        logs.append(np.asarray(logits if not torch.is_tensor(logits) else logits.numpy()))
        return logits, cache

    eng._decode = wrapped
    return logs


def engine_vs_reference(arch):
    """Both engines on the reference engine's params, max_batch 4: the
    logits of every decode call while the greedy tokens agree; a
    disagreement is allowed only on a near tie, and ends the comparison.
    Slots are refilled after retirement, through the slot reset."""
    jcfg, tcfg = _cfgs(arch)
    jeng = JServeEngine(jcfg, max_batch=4, cache_len=64)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jeng.params), "cpu")
    teng = TServeEngine(tcfg, max_batch=4, cache_len=64, device="cpu", params=tp)
    jlogs, tlogs = capture(jeng), capture(teng)
    for r in requests(JRequest, 8, seed=4):
        jeng.submit(r)
    for r in requests(TRequest, 8, seed=4):
        teng.submit(r)
    compared, diverged = 0, False
    while not diverged and (jeng.queue or any(jeng.slots)):
        jeng.step()
        teng.step()
        for a, b in zip(tlogs[compared:], jlogs[compared:]):
            top2 = np.sort(b, axis=-1)[:, -2:]
            tie = (top2[:, 1] - top2[:, 0]) <= 1e-4
            same = np.argmax(a, -1) == np.argmax(b, -1)
            if not same.all():
                assert tie[~same].all(), "greedy tokens differ away from a near tie"
                diverged = True
                break
            np.testing.assert_allclose(a, b, **LOGIT_TOL)
            compared += 1
    assert compared >= 40
    if not diverged:
        assert len(teng.completed) == len(jeng.completed) == 8
        jt = {r.request_id: r.generated for r in jeng.completed}
        assert all(r.generated == jt[r.request_id] for r in teng.completed)


def test_engine_matches_reference():
    engine_vs_reference(ARCH)


def test_ssm_engine_decodes():
    """The reference's ``tests/test_serve.py::test_ssm_engine_decodes``."""
    cfg = tget_arch(ARCH).reduced()
    eng = TServeEngine(cfg, max_batch=2, cache_len=64, device="cpu")
    for r in requests(TRequest, 3, seed=4):
        eng.submit(r)
    done = eng.run_until_drained()
    assert len(done) == 3


def slot_isolation(arch):
    """A request's decode logits are the same served alone and after a
    retired neighbour left its state in the same slot: the slot reset
    clears every cache leaf of that slot."""
    cfg = tget_arch(arch).reduced()
    params = tbuild(cfg).init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(12)
    first = rng.randint(0, cfg.vocab_size, 9).astype(np.int32)
    prompt = rng.randint(0, cfg.vocab_size, 6).astype(np.int32)

    def serve(neighbour):
        eng = TServeEngine(cfg, max_batch=1, cache_len=64, device="cpu", params=params)
        if neighbour:
            eng.submit(TRequest(1, first, max_new_tokens=5))
            eng.run_until_drained()
        logs = capture(eng)
        eng.submit(TRequest(0, prompt, max_new_tokens=6))
        done = eng.run_until_drained()
        return done[-1].generated, np.stack(logs)

    alone, busy = serve(False), serve(True)
    assert alone[0] == busy[0]
    np.testing.assert_array_equal(alone[1], busy[1])


def test_engine_slot_reset_isolates_requests():
    slot_isolation(ARCH)


def test_launch_serve_matches_reference_flow():
    """``launch.serve`` leaves the ssm cache as prefill and decode made it
    (no growth) and its prefill logits equal the reference's."""
    jm, _, jp, tp = _models(ARCH)
    res = tserve.serve(tget_arch(ARCH).reduced(), batch=2, prompt_len=16, gen=4, seed=3,
                       device="cpu", params=tp)
    jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(res.prompts.astype(np.int32))})
    np.testing.assert_allclose(res.prefill_logits.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert res.tokens.shape == (2, 4) and res.all_finite
    assert set(res.cache) == {"h", "conv"} and res.cache["h"].shape[1] == 2


def serve_cli(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--device", "cpu", "--arch", arch, "--reduced", "--batch", "2",
                     "--prompt-len", "8", "--gen", "4"])
    lines = out.getvalue().splitlines()
    assert lines[0] == f"arch={arch}-reduced batch=2 prompt=8 gen=4"
    ids = eval(lines[2].split(":", 1)[1])
    assert len(ids) == 4 and all(0 <= i < 512 for i in ids)


def test_serve_cli_on_cpu():
    serve_cli(ARCH)
