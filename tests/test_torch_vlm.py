"""Parity of the port's vlm family with the JAX reference, on the CPU:
``apply_mrope``, the attention blocks with M-RoPE, and the qwen2-vl LM's
prefill with prepended patch embeddings, decode, ``ServeEngine``,
``launch/serve.py`` (the reference's flow: 8 zero patches, decode from
position P), ``lm_loss`` and its gradients, at the reduced widths of
``qwen2-vl-2b`` (4 query heads over 2 KV heads of 64, M-RoPE sections
(8, 12, 12)), f32 and one bf16 case.

The same numpy inputs go through ``jax.jit`` of the reference and the
port; JAX params cross through ``convert.py``. Tolerances: M-RoPE and one
attention block rtol/atol 1e-5 (the same f32 angles; cos/sin and the
products may round differently); whole-model logits rtol/atol 1e-4 and
caches 1e-5 (as ``tests/test_torch_serve.py``); ``lm_loss`` rtol 1e-5 and
gradients rtol 1e-4 / atol 1e-6 (as ``tests/test_torch_train.py``); bf16
logits within 3% of their largest magnitude (8 bits, rounded at different
points).
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import layers as jL
from repro.models.registry import build_model as jbuild
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tL
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

ARCH = "qwen2-vl-2b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    return jget_arch(ARCH).reduced().with_(**kw), tget_arch(ARCH).reduced().with_(**kw)


def _models(seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, tm, jp, convert.params_from_numpy(jp, "cpu")


def _streams(B, S, seed):
    """Three distinct position streams (B, 3, S): sequential time, and
    height/width of a patch grid of 4 columns."""
    rng = np.random.RandomState(seed)
    t = np.arange(S)[None].repeat(B, 0) + rng.randint(0, 5, (B, 1))
    return np.stack([t, t // 4, t % 4 + 100], axis=1).astype(np.int32)


# ---------------------------------------------------------------- M-RoPE


@pytest.mark.parametrize("theta,sections", [(1_000_000.0, (8, 12, 12)),
                                            (10_000.0, (16, 24, 24)), (0.0, (8, 12, 12))])
def test_apply_mrope_equals_the_reference(theta, sections):
    D = 2 * sum(sections)
    x = np.random.RandomState(1).randn(2, 10, 4, D).astype(np.float32)
    pos = _streams(2, 10, 2)
    assert len({tuple(pos[0, i]) for i in range(3)}) == 3
    want = jax.jit(jL.apply_mrope, static_argnums=(2, 3))(jnp.asarray(x), jnp.asarray(pos),
                                                          theta, sections)
    got = tL.apply_mrope(_t(x), _t(pos), theta, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mrope_with_equal_streams_is_rope():
    x = np.random.RandomState(3).randn(2, 12, 4, 64).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0) + 7
    pos3 = np.repeat(pos[:, None], 3, axis=1)
    got = tL.apply_mrope(_t(x), _t(pos3), 1e6, (8, 12, 12))
    assert torch.equal(got, tL.apply_rope(_t(x), _t(pos), 1e6))
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        tL.apply_mrope(_t(x), _t(pos3), 1e6, (8, 12, 11))


def test_attention_blocks_with_mrope_equal_the_reference():
    """The prefill block on (B, 3, S) positions, then one decode step whose
    position broadcasts to the three streams."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jL.init_attention(jax.random.key(4), jcfg, jnp.float32))
    jp = {k: (v + 0.1 if k.startswith("b") else v) for k, v in jp.items()}  # live biases
    tp = convert.params_from_numpy(jp, "cpu")
    B, S = 2, 16
    x = np.random.RandomState(5).randn(B, S, jcfg.d_model).astype(np.float32)
    pos = _streams(B, S, 6)
    jout, (jk, jv) = jax.jit(lambda p, x, pos: jL.attention_block(p, x, jcfg, pos))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(pos))
    tout, (tk, tv) = tL.attention_block(tp, _t(x), tcfg, _t(pos))
    for a, b in ((tout, jout), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    W = 24
    cache = {"k": np.zeros((B, W, 2, 64), np.float32), "v": np.zeros((B, W, 2, 64), np.float32),
             "pos": np.full((B, W), -1, np.int32)}
    cache["k"][:, :S], cache["v"][:, :S] = np.asarray(jk), np.asarray(jv)
    cache["pos"][:, :S] = np.arange(S)
    xd = np.random.RandomState(7).randn(B, 1, jcfg.d_model).astype(np.float32)
    p1 = np.array([S, S + 3], np.int32)
    jd, jc = jax.jit(lambda p, x, pos, c: jL.attention_decode_block(p, x, jcfg, pos, c))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(xd), jnp.asarray(p1),
        jax.tree.map(jnp.asarray, cache))
    td, tc = tL.attention_decode_block(tp, _t(xd), tcfg, _t(p1).long(),
                                       {k: _t(v) for k, v in cache.items()})
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# ---------------------------------------------------------------- the LM


def _patches(B, n, dim, seed):
    return np.random.RandomState(seed).randn(B, n, dim).astype(np.float32)


def _close_cache(tc, jc):
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **CACHE_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_with_patches_and_decode_equal_the_reference(flash):
    """6 patch embeddings ahead of 18 tokens (two attention chunks), the
    cache grown, 5 decode steps on the reference's greedy tokens."""
    jm, tm, jp, tp = _models(use_flash_kernel=flash, attn_chunk=16)
    B, Np, P, gen = 2, 6, 18, 5
    toks = np.random.RandomState(9).randint(0, jm.cfg.vocab_size, (B, P)).astype(np.int32)
    batch = {"tokens": toks, "patches": _patches(B, Np, jm.cfg.frontend_dim, 10)}
    jl, jc = jax.jit(jm.prefill)(jp, jax.tree.map(jnp.asarray, batch))
    tl, tc = tm.prefill(tp, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc["k"].shape[2] == Np + P
    _close_cache(tc, jc)
    S = Np + P
    jc, tc = jm.grow_cache(jc, S + gen), tm.grow_cache(tc, S + gen)
    jdec = jax.jit(jm.decode)
    for s in range(gen):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32).reshape(B, 1)
        pos = np.full((B,), S + s, np.int32)
        jl, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos)})
        tl, tc = tm.decode(tp, tc, {"tokens": _t(tok), "pos": _t(pos)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _close_cache(tc, jc)


def test_prefill_bf16_equals_the_reference():
    jm, tm, jp, tp = _models(param_dtype="bfloat16", compute_dtype="bfloat16")
    toks = np.random.RandomState(11).randint(0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": toks, "patches": _patches(2, 8, jm.cfg.frontend_dim, 12)}
    jl, _ = jax.jit(jm.prefill)(jp, jax.tree.map(jnp.asarray, batch))
    tl, tc = tm.prefill(tp, {k: _t(v) for k, v in batch.items()})
    assert tc["k"].dtype == torch.bfloat16 and tp["vis_proj"].dtype == torch.bfloat16
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=0.03 * np.abs(jl).max())


def test_init_matches_the_reference_tree():
    want = jax.eval_shape(lambda: jbuild(jget_arch(ARCH).reduced()).init(jax.random.key(0)))
    got = tbuild(tget_arch(ARCH).reduced()).init(torch.Generator().manual_seed(0), "cpu")
    jl, tl = jax.tree_util.tree_flatten_with_path(want)[0], tree_flatten(got)[0]
    assert [".".join(str(k.key) for k in p) for p, _ in jl][-1] == "vis_proj"
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), path


def _requests(cls, n, seed=0, vocab=512):
    rng = np.random.RandomState(seed)
    return [cls(i, rng.randint(0, vocab, size=rng.randint(4, 12)).astype(np.int32),
                max_new_tokens=int(rng.randint(4, 16)))
            for i in range(n)]


def _capture(eng):
    logs, inner = [], eng._decode

    def wrapped(p, c, b):
        logits, cache = inner(p, c, b)
        logs.append(np.asarray(logits if not torch.is_tensor(logits) else logits.numpy()))
        return logits, cache

    eng._decode = wrapped
    return logs


def test_engine_matches_reference():
    """Both engines on the reference engine's params (text-only requests,
    M-RoPE decode): the logits of every decode call while the greedy tokens
    agree; a disagreement is allowed only on a near tie."""
    jcfg, tcfg = _cfgs()
    jeng = JServeEngine(jcfg, max_batch=4, cache_len=64)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jeng.params), "cpu")
    teng = TServeEngine(tcfg, max_batch=4, cache_len=64, device="cpu", params=tp)
    jlogs, tlogs = _capture(jeng), _capture(teng)
    for r in _requests(JRequest, 8, seed=5):
        jeng.submit(r)
    for r in _requests(TRequest, 8, seed=5):
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


def test_serve_driver_matches_reference_flow():
    """``launch.serve.serve`` against the reference's ``launch/serve.py``
    flow on the same params: 8 zero f32 patches prefilled ahead of P
    tokens, the cache grown to P + gen, decode from position P (over the
    cache slots of the prompt's last 8 tokens). Prefill logits, the greedy
    tokens (the reference's margins are asserted clear of ties) and the
    final cache."""
    jm, _, jp, tp = _models()
    B, P, gen = 2, 16, 5
    res = tserve.serve(tget_arch(ARCH).reduced(), batch=B, prompt_len=P, gen=gen, seed=3,
                       device="cpu", params=tp)
    batch = {"tokens": jnp.asarray(res.prompts.astype(np.int32)),
             "patches": jnp.zeros((B, 8, jm.cfg.frontend_dim), jnp.float32)}
    jl, jc = jax.jit(jm.prefill)(jp, batch)
    np.testing.assert_allclose(res.prefill_logits.numpy(), np.asarray(jl), **LOGIT_TOL)
    jc = jm.grow_cache(jc, P + gen)
    assert jc["k"].shape[2] == 8 + P  # already longer than P + gen: not grown
    jdec = jax.jit(jm.decode)
    toks, margins = [], []
    for s in range(gen):
        top2 = np.sort(np.asarray(jl), -1)[:, -2:]
        margins.append(float((top2[:, 1] - top2[:, 0]).min()))
        tok = jnp.argmax(jl, -1).astype(jnp.int32).reshape(B, 1)
        toks.append(np.asarray(tok))
        if s < gen - 1:
            jl, jc = jdec(jp, jc, {"tokens": tok, "pos": jnp.full((B,), P + s, jnp.int32)})
    assert min(margins) > 1e-3
    np.testing.assert_array_equal(res.tokens.numpy(), np.concatenate(toks, 1))
    assert res.all_finite
    _close_cache(res.cache, jc)
    # the decode steps overwrote the slots of positions P .. P + gen - 2
    assert (res.cache["pos"][:, :, P:P + gen - 1] == torch.arange(P, P + gen - 1)).all()


def test_serve_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "2",
                     "--prompt-len", "8", "--gen", "4"])
    lines = out.getvalue().splitlines()
    assert lines[0] == f"arch={ARCH}-reduced batch=2 prompt=8 gen=4"
    ids = eval(lines[2].split(":", 1)[1])
    assert len(ids) == 4 and all(0 <= i < 512 for i in ids)


# ---------------------------------------------------------------- lm_loss


def _port_value_and_grad(tm, tp, batch):
    leaves, structure = tree_flatten(tp)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss, _ = tm.loss(tree_unflatten(structure, live), batch)
    return loss.detach(), list(torch.autograd.grad(loss, live))


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads_equal_the_reference(remat):
    """Patches ahead of the tokens: the loss covers the token segment only,
    and ``vis_proj`` gets its gradient through the attention."""
    jm, tm, jp, tp = _models(remat=remat, loss_chunk=7, attn_chunk=16)
    rng = np.random.RandomState(13)
    b = {"tokens": rng.randint(0, jm.cfg.vocab_size, (2, 20)).astype(np.int32),
         "patches": _patches(2, 6, jm.cfg.frontend_dim, 14)}
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, b))
    tl, tg = _port_value_and_grad(tm, tp, {k: _t(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jg = jax.tree.leaves(jg)
    assert len(tg) == len(jg)
    assert float(np.abs(np.asarray(jg[-1])).max()) > 0  # vis_proj is trained
    for a, g in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), **GRAD_TOL)


@pytest.mark.parametrize("patches", [True, False])
def test_train_steps_equal_the_reference(patches):
    """Two SGD steps (an update linear in the gradient: Adam's first step
    moves a coordinate by about lr whatever its gradient's size, so a
    near-zero gradient's rounding would show; ``tests/test_torch_train.py``
    holds Adam) of the reference's train step against the port's, with the
    trainer's 8 zero patches and without any: ``vis_proj`` then gets zero
    gradients in both (``jax.grad`` of an unused param)."""
    from repro import optim as jopt
    from repro.launch import steps as jsteps
    from repro_torch import optim as topt
    from repro_torch.launch import steps as tsteps

    jm, tm, _, _ = _models(loss_chunk=7)
    jo, to = jopt.sgd(0.1), topt.sgd(0.1)
    jstate = jsteps.init_train_state(jm, jo, jax.random.key(0))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), "cpu")
    tstate = {"params": tparams, "opt": to.init(tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    jstep, tstep = jax.jit(jsteps.make_train_step(jm, jo)), tsteps.make_train_step(tm, to)
    rng = np.random.RandomState(15)
    for _ in range(2):
        b = {"tokens": rng.randint(0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)}
        if patches:
            b["patches"] = np.zeros((2, 8, jm.cfg.frontend_dim), np.float32)
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tmet = tstep(tstate, {k: _t(v) for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jstate["params"]), tree_flatten(tstate["params"])[0]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_train_cli_on_cpu():
    from repro_torch.launch import train as ttrain

    log = ttrain.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--log-every", "1"])
    assert [e["step"] for e in log] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in log)
