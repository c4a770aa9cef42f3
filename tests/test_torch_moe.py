"""Parity of the port's moe family with the JAX reference, on the CPU:
``_route_local``, ``moe_block``, the moe LM's prefill, decode,
``ServeEngine``, ``launch/serve.py``, ``lm_loss`` and its gradients, at
the reduced widths of ``kimi-k2-1t-a32b`` (4 experts, top 2) and
``arctic-480b`` (the same with a dense residual MLP), f32 and one bf16
case.

The same numpy inputs go through ``jax.jit`` of the reference and the
port; JAX params cross through ``convert.py``. Routing is a discontinuous
function of the router's logits, so every comparison first asserts that
the reference's smallest top-K margin (the gap between consecutive sorted
router probabilities down to the (K+1)-th) is far above f32 rounding
(``MIN_MARGIN``): a flipped expert then reads as a fault, not as noise.
Tolerances:

- routing: expert ids, ranks, keep flags and the safe expert/rank bit for
  bit (integer arithmetic on the same order); gates and aux rtol 1e-5: the
  router logits are an f32 product whose summation order differs between
  the packages (2 ulps, 1.9e-6, at |logit| 14.8 in the first case), and a
  probability moves by up to twice its logit's error (reading 1.8e-6
  relative; the softmax alone on equal logits 1.2e-7);
- ``moe_block`` f32 rtol/atol 1e-5 (three f32 matrix products of width
  <= 256 and an 8-way f32 combine: summation order only); bf16 atol 2e-2
  against outputs of order 1 (bf16 keeps 8 bits; the two packages round
  the expert products at different points);
- whole-model logits rtol/atol 1e-4 and caches 1e-5 (as
  ``tests/test_torch_serve.py``);
- ``lm_loss`` rtol 1e-5, gradients rtol 1e-4 / atol 1e-6 (as
  ``tests/test_torch_train.py``).
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

ARCHS = ["kimi-k2-1t-a32b", "arctic-480b"]
# f32 spacing at 1 is 1.2e-7 and the probabilities are below 1: a margin
# of 1e-5 is about a hundred roundings
MIN_MARGIN = 1e-5
GATE_TOL = dict(rtol=1e-5, atol=0)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _margin(xf, router, K):
    """The reference's smallest gap between consecutive sorted router
    probabilities over the top K + 1, over every token."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xf, jnp.float32) @ jnp.asarray(router), -1))
    top = -np.sort(-probs, axis=-1)[:, : K + 1]
    return float((top[:, :-1] - top[:, 1:]).min())


def _cfgs(name, **kw):
    return jget_arch(name).reduced().with_(**kw), tget_arch(name).reduced().with_(**kw)


def _models(name, seed=0, **kw):
    jcfg, tcfg = _cfgs(name, **kw)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, tm, jp, convert.params_from_numpy(jp, "cpu")


# ---------------------------------------------------------------- routing

# (T, d, E, K, C): tests/test_moe_routing.py's two cases (no drops; most
# pairs dropped), then top-2 with drops, and kimi's decode shape (4 tokens
# of 384 experts, C 1)
ROUTE_CASES = [(64, 16, 8, 2, 24), (32, 8, 2, 1, 4), (48, 16, 4, 2, 10), (4, 32, 384, 8, 1)]


@pytest.mark.parametrize("T,d,E,K,C", ROUTE_CASES)
def test_route_local_equals_the_reference(T, d, E, K, C):
    rng = np.random.RandomState(T + E)
    xf = rng.randn(T, d).astype(np.float32)
    router = rng.randn(d, E).astype(np.float32)
    assert _margin(xf, router, K) > MIN_MARGIN
    want = jax.jit(jL._route_local, static_argnums=(2, 3, 4))(
        jnp.asarray(xf), jnp.asarray(router), E, K, C)
    got = tL._route_local(_t(xf), _t(router), E, K, C)
    gate, sexp, srank, keep, aux = got
    assert sexp.dtype == torch.int64 and keep.dtype == torch.bool
    for name, a, b in (("safe_expert", sexp, want[1]), ("safe_rank", srank, want[2]),
                       ("keep", keep, want[3])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_allclose(gate.numpy(), np.asarray(want[0]), **GATE_TOL)
    np.testing.assert_allclose(float(aux), float(want[4]), **GATE_TOL)
    if (T, E, K, C) == (32, 2, 1, 4) or (T, E, K, C) == (48, 4, 2, 10):
        assert not keep.all()  # the drop cases do drop


def test_top_k_breaks_ties_by_the_lower_index():
    """``jax.lax.top_k``'s order: exact ties go to the lower expert."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = tL._top_k(_t(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------- moe_block


def _moe_inputs(name, dtype, dense_residual, seed=3):
    jcfg, tcfg = _cfgs(name, dense_residual=dense_residual)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.tree.map(np.asarray, jL.init_moe(jax.random.key(seed), jcfg, jdt))
    x = np.random.RandomState(seed).randn(2, 24, jcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jp, x


@pytest.mark.parametrize("dense_residual", [False, True])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_block_equals_the_reference(cf, dense_residual):
    jcfg, tcfg, jp, x = _moe_inputs("arctic-480b", "float32", dense_residual)
    assert _margin(x.reshape(-1, jcfg.d_model), jp["router"], jcfg.experts_per_token) \
        > MIN_MARGIN
    fn = jax.jit(lambda p, x: jL.moe_block(p, x, jcfg, capacity_factor=cf))
    jout, jaux = fn(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tout, taux = tL.moe_block(convert.params_from_numpy(jp, "cpu"), _t(x), tcfg,
                              capacity_factor=cf)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **GATE_TOL)
    T, E, K = 48, jcfg.n_experts, jcfg.experts_per_token
    C = max(1, int(T * K / E * cf))
    keep = tL._route_local(_t(x).reshape(T, -1), _t(jp["router"]), E, K, C)[3]
    assert keep.all() == (cf == 1.25)  # capacity 30 keeps every pair, 12 drops some


def test_moe_block_bf16_equals_the_reference():
    jcfg, tcfg, jp, x = _moe_inputs("kimi-k2-1t-a32b", "bfloat16", False)
    xb = jnp.asarray(x, jnp.bfloat16)
    xb32 = np.asarray(xb.astype(jnp.float32))
    assert _margin(xb32.reshape(-1, jcfg.d_model), jp["router"], jcfg.experts_per_token) \
        > MIN_MARGIN
    jout, jaux = jax.jit(lambda p, x: jL.moe_block(p, x, jcfg))(
        jax.tree.map(jnp.asarray, jp), xb)
    tp = convert.params_from_numpy(jp, "cpu")
    assert tp["router"].dtype == torch.float32 and tp["w_gate"].dtype == torch.bfloat16
    tout, taux = tL.moe_block(tp, _t(xb32).to(torch.bfloat16), tcfg)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tout), _f32(jout), rtol=0, atol=2e-2)
    np.testing.assert_allclose(float(taux), float(jaux), **GATE_TOL)


def test_init_moe_matches_the_reference_tree():
    """Leaf names, shapes and dtypes, stacked on the layer axis, the router
    in f32 under bf16 params."""
    cfg = jget_arch("arctic-480b").with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                                         d_ff=96, moe_d_ff=80, n_experts=6, vocab_size=128)
    want = jax.eval_shape(lambda: jbuild(cfg).init(jax.random.key(0)))
    got = tbuild(tget_arch("arctic-480b").with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, moe_d_ff=80, n_experts=6,
        vocab_size=128)).init(torch.Generator().manual_seed(0), "cpu")
    jl, tl = jax.tree_util.tree_flatten_with_path(want)[0], tree_flatten(got)[0]
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
    assert got["layers"]["moe"]["router"].dtype == torch.float32
    assert got["layers"]["moe"]["dense_mlp"]["w_down"].shape == (2, 96, 64)


# ---------------------------------------------------------------- the LM


def _close_cache(tc, jc):
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **CACHE_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_the_reference(arch):
    """Prefill (logits and cache), grow the cache, 6 decode steps on the
    reference's greedy tokens; every layer routes B * S = 40 tokens in
    prefill and 2 in decode (capacity 1: decode drops pairs)."""
    jm, tm, jp, tp = _models(arch, attn_chunk=8)
    B, P, gen = 2, 20, 6
    toks = np.random.RandomState(7).randint(0, jm.cfg.vocab_size, (B, P)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _close_cache(tc, jc)
    jc, tc = jm.grow_cache(jc, P + gen), tm.grow_cache(tc, P + gen)
    jdec = jax.jit(jm.decode)
    for s in range(gen):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32).reshape(B, 1)
        pos = np.full((B,), P + s, np.int32)
        jl, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos)})
        tl, tc = tm.decode(tp, tc, {"tokens": torch.from_numpy(tok),
                                    "pos": torch.from_numpy(pos)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _close_cache(tc, jc)


def test_prefill_bf16_equals_the_reference():
    """bf16 params and compute: logits within 3% of their largest
    magnitude (bf16 keeps 8 bits; one routing difference would move a
    token's logits by their full size)."""
    jm, tm, jp, tp = _models("kimi-k2-1t-a32b", param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    toks = np.random.RandomState(8).randint(0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tc["k"].dtype == torch.bfloat16
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=0.03 * np.abs(jl).max())


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


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch, monkeypatch):
    """Both engines on the reference engine's params, max_batch 4: every
    decode call routes 4 tokens at capacity int(4 * 2 / 4 * 1.25) = 2, so
    one slot's pairs (an idle slot's included) can drop another's. The
    logits of every call are compared while the greedy tokens agree; a
    disagreement is allowed only on a near tie, and ends the comparison."""
    jcfg, tcfg = _cfgs(arch)
    jeng = JServeEngine(jcfg, max_batch=4, cache_len=64)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jeng.params), "cpu")
    teng = TServeEngine(tcfg, max_batch=4, cache_len=64, device="cpu", params=tp)
    drops, route = [], tL._route_local

    def counting(xf, router, E, K, C):
        out = route(xf, router, E, K, C)
        drops.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(tL, "_route_local", counting)
    jlogs, tlogs = _capture(jeng), _capture(teng)
    for r in _requests(JRequest, 8, seed=4):
        jeng.submit(r)
    for r in _requests(TRequest, 8, seed=4):
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
    assert sum(drops) > 0, "no decode step dropped a pair"
    if not diverged:
        assert len(teng.completed) == len(jeng.completed) == 8
        jt = {r.request_id: r.generated for r in jeng.completed}
        assert all(r.generated == jt[r.request_id] for r in teng.completed)


def test_serve_driver_matches_reference_flow():
    jm, _, jp, tp = _models("arctic-480b")
    res = tserve.serve(tget_arch("arctic-480b").reduced(), batch=2, prompt_len=16, gen=4,
                       seed=3, device="cpu", params=tp)
    jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(res.prompts.astype(np.int32))})
    np.testing.assert_allclose(res.prefill_logits.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert res.tokens.shape == (2, 4) and res.all_finite
    assert res.cache["k"].shape[2] == 16 + 4


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--device", "cpu", "--arch", arch, "--reduced", "--batch", "2",
                     "--prompt-len", "8", "--gen", "4"])
    lines = out.getvalue().splitlines()
    assert lines[0] == f"arch={arch}-reduced batch=2 prompt=8 gen=4"
    ids = eval(lines[2].split(":", 1)[1])
    assert len(ids) == 4 and all(0 <= i < 512 for i in ids)


# ---------------------------------------------------------------- lm_loss


def _port_value_and_grad(tm, tp, batch):
    leaves, structure = tree_flatten(tp)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss, metrics = tm.loss(tree_unflatten(structure, live), batch)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, list(torch.autograd.grad(loss, live))


def _ref_value_and_grad(jm, jp, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    return loss, metrics, jax.tree.leaves(grads)


def _loss_batch(vocab):
    return {"tokens": np.random.RandomState(11).randint(0, vocab, (2, 24)).astype(np.int32)}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_equal_the_reference(arch, remat):
    jm, tm, jp, tp = _models(arch, remat=remat, loss_chunk=7, attn_chunk=16)
    b = _loss_batch(jm.cfg.vocab_size)
    jl, jmet, jg = _ref_value_and_grad(jm, jp, b)
    tl, tmet, tg = _port_value_and_grad(tm, tp, {k: _t(v) for k, v in b.items()})
    assert float(jmet["aux"]) > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]), rtol=1e-5)
    assert len(tg) == len(jg)
    for a, g in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), **GRAD_TOL)


def test_lm_loss_keeps_the_router_aux_under_remat():
    """remat wraps each block in ``checkpoint``; the block's aux must come
    out of it: the loss, aux and the router's gradient are equal with remat
    on and off, and equal the reference's (whose router gradient comes
    from the aux term alone through ``me``, and from the gates)."""
    jm, tm, jp, tp = _models("kimi-k2-1t-a32b", loss_chunk=512)
    b = _loss_batch(jm.cfg.vocab_size)
    tb = {k: _t(v) for k, v in b.items()}
    runs = {}
    for remat in (False, True):
        m = tbuild(tm.cfg.with_(remat=remat))
        runs[remat] = _port_value_and_grad(m, tp, tb)
    names = [".".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    ri = names.index("layers.moe.router")
    (l0, m0, g0), (l1, m1, g1) = runs[False], runs[True]
    assert float(m1["aux"]) > 0
    assert float(l0) == float(l1) and float(m0["aux"]) == float(m1["aux"])
    assert torch.equal(g0[ri], g1[ri])
    # the aux term is in the loss: drop it and the loss moves
    assert float(l1) != float(m1["ce"])
    jl, jmet, jg = _ref_value_and_grad(jm, jp, b)
    np.testing.assert_allclose(float(l1), float(jl), rtol=1e-5)
    np.testing.assert_allclose(g1[ri].numpy(), np.asarray(jg[ri]), **GRAD_TOL)
    jl_aux = float(jl) - float(jmet["ce"])
    assert jl_aux == pytest.approx(jm.cfg.router_aux_coef * float(jmet["aux"]) / 2, rel=1e-3)


# ---------------------------------------------------------------- memory


def test_tree_helpers_leave_no_reference_cycle():
    """Flattening a param tree must not keep its leaves alive: the
    families phase frees a 55 GB MoE model between configs, and a
    reference cycle held every leaf until the cycle collector ran."""
    import gc
    import weakref

    from repro_torch.core.tree import tree_leaves, tree_map

    params = tbuild(tget_arch("arctic-480b").reduced()).init(
        torch.Generator().manual_seed(0), "cpu")
    ref = weakref.ref(params["embed"])
    gc.disable()
    try:
        n = sum(t.numel() for t in tree_leaves(params))
        halves = tree_map(lambda t: t * 0.5, params)
        unflat = tree_unflatten(*reversed(tree_flatten(params)))
        assert n > 0 and unflat["embed"] is params["embed"]
        del params, halves, unflat
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_equal_the_reference(arch):
    """Two SGD steps of the reference's train step against the port's (an
    update linear in the gradient; ``tests/test_torch_train.py`` holds
    Adam): the router (f32) and the experts move as the reference's."""
    from repro import optim as jopt
    from repro.launch import steps as jsteps
    from repro_torch import optim as topt
    from repro_torch.launch import steps as tsteps

    jm, tm, _, _ = _models(arch, loss_chunk=7)
    jo, to = jopt.sgd(0.1), topt.sgd(0.1)
    jstate = jsteps.init_train_state(jm, jo, jax.random.key(0))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), "cpu")
    tstate = {"params": tparams, "opt": to.init(tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    jstep, tstep = jax.jit(jsteps.make_train_step(jm, jo)), tsteps.make_train_step(tm, to)
    rng = np.random.RandomState(16)
    for _ in range(2):
        b = rng.randint(0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(b)})
        tstate, tmet = tstep(tstate, {"tokens": torch.from_numpy(b)})
        for k in ("loss", "grad_norm", "aux"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jstate["params"]), tree_flatten(tstate["params"])[0]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
