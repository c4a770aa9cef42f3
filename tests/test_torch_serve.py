"""Parity of the port's dense-LM serving path (``prefill``, ``decode_step``,
``grow_cache``, ``ServeEngine``, ``launch/serve.py``) with the JAX
reference, on the CPU, in f32, at the reduced widths of ``stablelm-1.6b``
and ``qwen3-8b`` with 2 KV heads (GQA).

JAX params cross to the port through ``convert.py``; prompts come from
numpy. Whole-model logits agree within rtol/atol 1e-4 (two layers of f32
matrix products and a 512-way head, summation order only); caches within
1e-5. Untrained logits can nearly tie, so greedy tokens are compared only
where the top-2 margin exceeds the tolerance (as ``tests/test_serve.py``
does): decoding feeds both packages the reference's own tokens.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models.registry import build_model as jbuild
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch
from repro_torch.launch import serve as tserve
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["stablelm-1.6b", "qwen3-8b"]


def _cfgs(name, **kw):
    j, t = jget_arch(name).reduced(), tget_arch(name).reduced()
    if name == "qwen3-8b":
        kw.setdefault("n_kv_heads", 2)
    return j.with_(**kw), t.with_(**kw)


def _models(name, **kw):
    jcfg, tcfg = _cfgs(name, **kw)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    return jm, tm, jp, convert.params_from_numpy(jp, "cpu")


def _close_cache(tc, jc, S=None):
    for n in ("k", "v"):
        a, b = tc[n].numpy(), np.asarray(jc[n])
        if S is not None:
            a, b = a[:, :, :S], b[:, :, :S]
        np.testing.assert_allclose(a, b, **CACHE_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("S", [24, 130])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(arch, S, flash):
    jm, tm, jp, tp = _models(arch, use_flash_kernel=flash, attn_chunk=64)
    toks = np.random.RandomState(S).randint(0, jm.cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (2, jm.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _close_cache(tc, jc)


def test_flash_and_chunked_prefill_agree():
    """As the reference's own test: routing prefill through the flash
    kernel moves log-softmax logits by less than 2e-3."""
    _, tm, _, tp = _models("qwen3-8b")
    tm_fl = tbuild(tm.cfg.with_(use_flash_kernel=True))
    toks = torch.from_numpy(np.random.RandomState(9).randint(0, 512, (2, 24)).astype(np.int32))
    a, _ = tm.prefill(tp, {"tokens": toks})
    b, _ = tm_fl.prefill(tp, {"tokens": toks})
    np.testing.assert_allclose(torch.log_softmax(b, -1).numpy(),
                               torch.log_softmax(a, -1).numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("window,P", [(0, 20), (16, 12)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_after_grow_cache(arch, window, P):
    """Prefill, grow the cache, 8 greedy decode steps (the reference's
    tokens fed to both); window 16 wraps the ring buffer."""
    jm, tm, jp, tp = _models(arch)
    gen = 8
    toks = np.random.RandomState(P).randint(0, jm.cfg.vocab_size, (3, P)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jc = jm.grow_cache(jc, window or P + gen)
    tc = tm.grow_cache(tc, window or P + gen)
    _close_cache(tc, jc)
    for s in range(gen):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32).reshape(3, 1)
        pos = np.full((3,), P + s, np.int32)
        jl, jc = jm.decode(jp, jc, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos)},
                           window=window)
        tl, tc = tm.decode(tp, tc, {"tokens": torch.from_numpy(tok),
                                    "pos": torch.from_numpy(pos)}, window=window)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _close_cache(tc, jc)


def test_model_api_matches_reference():
    jm, tm, jp, tp = _models("qwen3-8b")
    for n in (100, 32_768, 40_000):
        assert tm.cache_len_for(n) == jm.cache_len_for(n)
        assert tm.decode_window_for(n) == jm.decode_window_for(n)
    jc = jm.init_cache(2, 10)
    tc = tm.init_cache(2, 10, "cpu")
    _close_cache(tc, jc)
    # the dense loss is the training loss (tests/test_torch_train.py holds
    # it and its gradients against the jitted reference)
    toks = np.random.RandomState(5).randint(0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _ = jax.jit(jm.loss)(jax.tree.map(jnp.asarray, jp), {"tokens": jnp.asarray(toks)})
    tl, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def _requests(cls, n, seed=0, vocab=512):
    rng = np.random.RandomState(seed)
    return [cls(i, rng.randint(0, vocab, size=rng.randint(4, 12)).astype(np.int32),
                max_new_tokens=int(rng.randint(4, 16)))
            for i in range(n)]


def _capture(eng):
    """Record every decode call's logits (as f32 numpy)."""
    logs, inner = [], eng._decode

    def wrapped(p, c, b):
        logits, cache = inner(p, c, b)
        logs.append(np.asarray(logits if not torch.is_tensor(logits) else logits.numpy()))
        return logits, cache

    eng._decode = wrapped
    return logs


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch):
    """Both engines on the reference engine's params: per-slot KV rows
    after prefill, and the logits of every decode call while the greedy
    tokens agree; a disagreement is allowed only on a near tie, and ends
    the comparison."""
    jcfg, tcfg = _cfgs(arch)
    jeng = JServeEngine(jcfg, max_batch=4, cache_len=96)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jeng.params), "cpu")
    teng = TServeEngine(tcfg, max_batch=4, cache_len=96, device="cpu", params=tp)
    jlogs, tlogs = _capture(jeng), _capture(teng)
    for r in _requests(JRequest, 8, seed=2):
        jeng.submit(r)
    for r in _requests(TRequest, 8, seed=2):
        teng.submit(r)
    jeng.step()
    teng.step()
    for s in range(4):  # every slot's prompt rows after the token-by-token prefill
        P = len(teng.slots[s].prompt)
        assert P == len(jeng.slots[s].prompt)
        for n in ("k", "v"):
            np.testing.assert_allclose(teng.cache[n][:, s, :P].numpy(),
                                       np.asarray(jeng.cache[n][:, s, :P]), **CACHE_TOL)
        np.testing.assert_array_equal(teng.cache["pos"][:, s].numpy(),
                                      np.asarray(jeng.cache["pos"][:, s]))
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
        assert teng.stats()["tokens_per_step"] == pytest.approx(jeng.stats()["tokens_per_step"])


def test_engine_drains_and_batches_continuously():
    cfg = tget_arch("stablelm-1.6b").reduced()
    eng = TServeEngine(cfg, max_batch=4, cache_len=96, device="cpu")
    for r in _requests(TRequest, 8, seed=1):
        eng.submit(r)
    done = eng.run_until_drained()
    assert len(done) == 8
    for r in done:
        assert r.state == "DONE" and 1 <= len(r.generated) <= r.max_new_tokens
    s = eng.stats()
    assert s["completed"] == 8 and s["tokens_per_step"] > 1.0


def test_engine_slot_reset_isolates_requests():
    """A slot's cache rows after prefill do not depend on what the slot
    (or its neighbours) held before."""
    cfg = tget_arch("qwen3-8b").reduced().with_(n_kv_heads=2)
    prompt = np.arange(1, 9, dtype=np.int32)

    def rows(extra):
        eng = TServeEngine(cfg, max_batch=2, cache_len=48, device="cpu")
        if extra:
            for r in _requests(TRequest, 3, seed=3):
                r.request_id += 100
                eng.submit(r)
            eng.run_until_drained()
        eng.submit(TRequest(0, prompt, max_new_tokens=4))
        eng.step()
        s = next(r for r in eng.slots + eng.completed if r and r.request_id == 0).slot
        return {n: eng.cache[n][:, s].clone() for n in ("k", "v", "pos")}

    a, b = rows(False), rows(True)
    for n in ("k", "v", "pos"):
        assert torch.equal(a[n], b[n])


def test_serve_driver_matches_reference_flow():
    """``launch.serve.serve`` on the reference's params: prefill logits and
    the greedy tokens wherever the reference's margin is not a near tie."""
    jm, _, jp, tp = _models("stablelm-1.6b")
    res = tserve.serve(tget_arch("stablelm-1.6b").reduced(), batch=2,
                       prompt_len=16, gen=4, seed=3, device="cpu", params=tp)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(res.prompts.astype(np.int32))})
    np.testing.assert_allclose(res.prefill_logits.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert res.tokens.shape == (2, 4) and res.all_finite
    assert res.cache["k"].shape[2] == 16 + 4


def test_serve_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--device", "cpu", "--arch", "stablelm-1.6b", "--reduced",
                     "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    lines = out.getvalue().splitlines()
    assert lines[0] == "arch=stablelm-1.6b-reduced batch=2 prompt=8 gen=4"
    assert lines[1].startswith("prefill: ") and "ms/token" in lines[1]
    ids = eval(lines[2].split(":", 1)[1])
    assert len(ids) == 4 and all(0 <= i < 512 for i in ids)


def test_entry_points_want_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError):
        TServeEngine(tget_arch("stablelm-1.6b").reduced())
    with pytest.raises(RuntimeError):
        tserve.serve(tget_arch("stablelm-1.6b").reduced())
