"""Parity of the port's dense-LM training path with the JAX reference, on
the CPU: ``lm_loss`` and its gradients, the block-state quantizers, the
schedules, ``clip_by_global_norm``, ``make_train_step`` with every
optimizer, the train state's shapes, the Markov token stream and the
training CLI with its checkpoints.

The same numpy inputs go to both packages; JAX params cross to the port
through ``convert.py``. Tolerances, each against ``jax.jit`` of the
reference:

- f32 loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6 (two layers of f32
  matrix products: summation order only);
- bf16 loss rtol 1e-3, and per leaf a gradient error within 3% of the
  leaf's largest gradient and a relative L2 error within 3%: bf16 keeps 8
  bits, and the two packages round products and their cotangents to bf16
  at different points (readings: up to 1.7e-4 and 1.5%);
- block-state quantizers, the clip at the reference's norm, the token
  stream: bit for bit;
- schedules within 4 ulps of the peak rate (``cos`` is a libm call, and
  near the cosine's floor ``1 + cos`` cancels its leading digits);
- three train steps: loss and grad norm rtol 1e-5; f32 state rtol 1e-4 /
  atol 1e-7; params atol 1e-6 with f32 moments, 2e-5 with quantized ones
  (a sqrt(v) symbol one int8 step apart moves that coordinate's step by up
  to its lr; readings 1.6e-7 and 4.9e-6 at lr 1e-3), at most 1% of the
  int8 symbols one step apart (reading 0.33%), and bf16 moments rtol 2^-6
  / atol 1e-5 (one bf16 rounding of gradients taken at params up to 2e-5
  apart; reading 1.7e-6 at a moment of 1.1e-5).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs.base import get_arch as jget_arch
from repro.core import quant as jquant
from repro.data import lm as jlm
from repro.launch import steps as jsteps
from repro.models.registry import build_model as jbuild
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.ckpt import load_checkpoint
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import list_archs
from repro_torch.core import quant as tquant
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.data import MarkovTokens, token_batches
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TF
from repro_torch.models.registry import build_model as tbuild

ARCHS = ["stablelm-1.6b", "qwen3-8b"]
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128)


def _cfgs(name, **kw):
    j, t = jget_arch(name).reduced(), tget_arch(name).reduced()
    if name == "qwen3-8b":
        kw.setdefault("n_kv_heads", 2)
    return j.with_(**kw), t.with_(**kw)


def _models(name, seed=0, **kw):
    jcfg, tcfg = _cfgs(name, **kw)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, tm, jp, convert.params_from_numpy(jp, "cpu")


def _np(x):
    """Leaf -> numpy f32 (bf16 widened), for comparisons."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _port_value_and_grad(tm, tp, batch):
    leaves, structure = tree_flatten(tp)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss, metrics = tm.loss(tree_unflatten(structure, live), batch)
    return loss.detach(), metrics, list(torch.autograd.grad(loss, live))


def _ref_value_and_grad(jm, jp, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    return loss, metrics, jax.tree.leaves(grads)


def _batches(kind, vocab, B=2, S=24, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (B, S)).astype(np.int32)
    if kind == "tokens":
        return {"tokens": toks}
    if kind == "labels":
        return {"tokens": toks, "labels": rng.randint(0, vocab, (B, S)).astype(np.int32)}
    mask = (rng.rand(B, S) < 0.7).astype(np.int32)
    return {"tokens": toks, "mask": mask}


# ---------------------------------------------------------------- lm_loss


@pytest.mark.parametrize("arch,kind,loss_chunk", [
    ("stablelm-1.6b", "labels", 16),
    ("stablelm-1.6b", "mask", 7), ("qwen3-8b", "tokens", 512), ("qwen3-8b", "mask", 7)])
def test_lm_loss_and_grads_equal_the_reference(arch, kind, loss_chunk):
    """f32; loss_chunk 7 and 16 do not divide T = 23 (a zero-padded tail);
    two attention chunks."""
    jm, tm, jp, tp = _models(arch, loss_chunk=loss_chunk, attn_chunk=16)
    b = _batches(kind, jm.cfg.vocab_size)
    jl, jmet, jg = _ref_value_and_grad(jm, jp, b)
    tl, tmet, tg = _port_value_and_grad(tm, tp, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["ce"].detach()), float(jmet["ce"]), rtol=1e-5)
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    assert len(tg) == len(jg)
    for a, b_ in zip(jg, tg):
        assert b_.dtype == torch.float32 and tuple(b_.shape) == a.shape
        np.testing.assert_allclose(_np(b_), _np(a), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed", [1])
def test_bf16_lm_loss_and_grads_within_bf16_rounding(seed):
    jm, tm, jp, tp = _models("stablelm-1.6b", seed=seed, param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    b = _batches("tokens", jm.cfg.vocab_size, seed=seed)
    jl, _, jg = _ref_value_and_grad(jm, jp, b)
    tl, _, tg = _port_value_and_grad(tm, tp, {"tokens": torch.from_numpy(b["tokens"])})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    for a, b_ in zip(jg, tg):
        assert b_.dtype == torch.bfloat16
        a, b_ = _np(a), _np(b_)
        assert np.abs(a - b_).max() <= 0.03 * np.abs(a).max()
        assert np.linalg.norm(a - b_) <= 0.03 * np.linalg.norm(a)


@pytest.mark.parametrize("flags", [dict(remat=True), dict(unroll_layers=True, unroll_attn=True),
                                   dict(remat=True, unroll_layers=True)])
def test_remat_and_unroll_change_no_bit(flags):
    tm = tbuild(_cfgs("qwen3-8b", attn_chunk=16, loss_chunk=16)[1])
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    tm_on = tbuild(tm.cfg.with_(**flags))
    b = {k: torch.from_numpy(v) for k, v in _batches("mask", 512).items()}
    l0, _, g0 = _port_value_and_grad(tm, tp, b)
    l1, _, g1 = _port_value_and_grad(tm_on, tp, b)
    assert torch.equal(l0, l1)
    for a, b_ in zip(g0, g1):
        assert torch.equal(a, b_)


def test_full_configs_carry_the_reference_fields():
    for name in ("stablelm-1.6b", "qwen3-8b", "deepseek-67b", "qwen1.5-110b",
                 "kimi-k2-1t-a32b", "arctic-480b", "qwen2-vl-2b", "falcon-mamba-7b",
                 "zamba2-2.7b"):
        j, t = jget_arch(name), tget_arch(name)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
                  "qkv_bias", "qk_norm", "rope_theta", "source", "param_dtype", "remat",
                  "loss_chunk", "unroll_layers", "unroll_attn", "attn_chunk"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert t.reduced().remat is False and t.remat is True
    assert TF.LOSS_CHUNK == 512 == tget_arch("stablelm-1.6b").loss_chunk
    assert {"deepspeech2", "stablelm-1.6b", "qwen3-8b", "deepseek-67b", "qwen1.5-110b",
            "kimi-k2-1t-a32b", "arctic-480b", "qwen2-vl-2b", "falcon-mamba-7b",
            "zamba2-2.7b", "whisper-tiny"} == set(list_archs())


def test_qkv_bias_config_trains_like_the_reference():
    """qwen1.5-110b reduced (QKV bias) at f32: loss and gradients."""
    jcfg = jget_arch("qwen1.5-110b").reduced().with_(**TINY)
    tcfg = tget_arch("qwen1.5-110b").reduced().with_(**TINY)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(3)))
    rng = np.random.RandomState(3)
    for n in ("bq", "bk", "bv"):  # non-zero biases
        a = jp["layers"]["attn"][n]
        jp["layers"]["attn"][n] = (rng.randn(*a.shape) * 0.1).astype(a.dtype)
    tp = convert.params_from_numpy(jp, "cpu")
    b = _batches("tokens", TINY["vocab_size"], S=24)
    jl, _, jg = _ref_value_and_grad(jm, jp, b)
    tl, _, tg = _port_value_and_grad(tm, tp, {"tokens": torch.from_numpy(b["tokens"])})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b_ in zip(jg, tg):
        np.testing.assert_allclose(_np(b_), _np(a), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- block-state quantizers


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("size,block", [(1000, 256), (768, 256), (300, 0), (300, -1),
                                        (256, 256), (100, 256), (5, 2)])
def test_quantize_state_equals_the_jitted_reference(size, block, bits):
    """A ragged last block (1000 = 3 x 256 + 232), exact blocks, block <= 0
    and block >= size (one per-tensor scale), heavy-tailed values."""
    rng = np.random.RandomState(size + bits)
    x = (rng.randn(size) * np.exp(rng.randn(size) * 2)).astype(np.float32).reshape(-1, 1)
    jq, js = jquant.quantize_state(jnp.asarray(x), bits=bits, block=block)
    tq, ts = tquant.quantize_state(torch.from_numpy(x), bits=bits, block=block)
    assert tq.dtype == torch.int8 and tuple(tq.shape) == x.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jquant.dequantize_state(jq, js, block=block if block > 0 else tquant.STATE_BLOCK)
    td = tquant.dequantize_state(tq, ts, block=block if block > 0 else tquant.STATE_BLOCK)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tquant.STATE_BLOCK == jquant.STATE_BLOCK
    with pytest.raises(ValueError):
        tquant.quantize_state(torch.from_numpy(x), bits=9)


def test_quantize_state_of_zeros_and_multi_dim():
    x = np.zeros((3, 5, 40), np.float32)
    x[1, 2] = np.linspace(-3, 3, 40)
    for arr in (x, np.zeros((7,), np.float32)):
        jq, js = jquant.quantize_state(jnp.asarray(arr))
        tq, ts = tquant.quantize_state(torch.from_numpy(arr))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------------- schedules and clip


def _sched_pairs():
    return [
        ("constant", jopt.constant_schedule(3e-4), topt.constant_schedule(3e-4), 20, 3e-4),
        ("cosine", jopt.cosine_schedule(3e-4, 20), topt.cosine_schedule(3e-4, 20), 20, 3e-4),
        ("warmup_cosine", jopt.linear_warmup_cosine(1e-3, 5, 20),
         topt.linear_warmup_cosine(1e-3, 5, 20), 20, 1e-3),
        ("warmup_cosine_1", jopt.linear_warmup_cosine(1e-3, 1, 6),
         topt.linear_warmup_cosine(1e-3, 1, 6), 6, 1e-3),
    ]


@pytest.mark.parametrize("which", range(4))
def test_schedules_equal_the_reference(which):
    _, js, ts, total, lr = _sched_pairs()[which]
    steps = sorted({0, 1, 4, 5, 6, total // 2, total - 1, total, total + 3})
    jitted = jax.jit(js)
    for s in steps:
        got = ts(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        for want in (js(jnp.int32(s)), jitted(jnp.int32(s))):
            want = np.float32(want)
            assert abs(float(got) - float(want)) <= 4 * np.spacing(np.float32(lr)), (s, got, want)


def test_clip_by_global_norm_divides_as_the_reference():
    """Given the reference's norm, the clipped leaves equal ``jax.jit`` of
    the reference bit for bit. The former port computed ``max_norm / norm``
    with a Python float over a tensor, which PyTorch evaluates as
    ``reciprocal(norm) * max_norm``: one ulp off for some norms."""
    ref_clip = jax.jit(jopt.clip_by_global_norm, static_argnums=1)
    compared = reciprocal_off = 0
    for seed in range(40):
        rng = np.random.RandomState(seed)
        leaves = [(rng.randn(17, 5) * 0.3).astype(np.float32) for _ in range(3)]
        for max_norm in (0.37, 2.5):
            jc, jn = ref_clip([jnp.asarray(a) for a in leaves], max_norm)
            tc, tn = topt.clip_by_global_norm([torch.from_numpy(a) for a in leaves], max_norm)
            np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
            if float(tn) != float(jn):
                continue  # reduction order; the parity contract allows it
            compared += 1
            for a, b in zip(jc, tc):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            recip = torch.clamp_max(max_norm / torch.clamp_min(tn, 1e-12), 1.0)
            divided = torch.clamp_max(torch.tensor(max_norm) / torch.clamp_min(tn, 1e-12), 1.0)
            reciprocal_off += int(not torch.equal(recip, divided))
    assert compared >= 20
    assert reciprocal_off >= 1  # the old form is caught by this comparison


# ---------------------------------------------------------------- train step


def _opts(mod, name, quantize):
    sched = mod.linear_warmup_cosine(1e-2 if name in ("sgd", "momentum") else 1e-3, 1, 3)
    if name == "sgd":
        return mod.sgd(sched)
    return getattr(mod, name)(sched, quantize=quantize)


@pytest.mark.parametrize("name,quantize", [("sgd", False), ("momentum", False),
                                           ("momentum", True), ("adam", False),
                                           ("adam", True), ("adamw", False), ("adamw", True)])
def test_three_train_steps_track_the_reference(name, quantize):
    jcfg, tcfg = _cfgs("qwen3-8b", **TINY)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jo, to = _opts(jopt, name, quantize), _opts(topt, name, quantize)
    jstate = jsteps.init_train_state(jm, jo, jax.random.key(0))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), "cpu")
    tstate = {"params": tparams, "opt": to.init(tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    assert topt.state_nbytes(tstate["opt"]) == jopt.state_nbytes(jstate["opt"])
    jstep, tstep = jax.jit(jsteps.make_train_step(jm, jo)), tsteps.make_train_step(tm, to)
    rng = np.random.RandomState(0)
    for _ in range(3):
        b = rng.randint(0, TINY["vocab_size"], (2, 24)).astype(np.int32)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(b)})
        tstate, tmet = tstep(tstate, {"tokens": torch.from_numpy(b)})
        for k in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert tstate["step"].dtype == torch.int32
    atol = 2e-5 if quantize and name != "momentum" else 1e-6
    for a, b in zip(jax.tree.leaves(jstate["params"]), tree_flatten(tstate["params"])[0]):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=atol)
    assert topt.state_nbytes(tstate["opt"]) == jopt.state_nbytes(jstate["opt"])
    jleaves = jax.tree_util.tree_leaves_with_path(jstate["opt"])
    tleaves = tree_flatten(tstate["opt"])[0]
    assert len(jleaves) == len(tleaves)
    flips = total = 0
    for (path, a), b in zip(jleaves, tleaves):
        key = jax.tree_util.keystr(path)
        assert str(b.dtype).split(".")[-1] == np.asarray(a).dtype.name
        if "v_q" in key:
            d = np.abs(b.numpy().astype(np.int32) - np.asarray(a).astype(np.int32))
            assert d.max() <= 1
            flips, total = flips + int((d > 0).sum()), total + d.size
        elif b.dtype == torch.bfloat16:  # quantized m: a bf16 rounding apart
            np.testing.assert_allclose(_np(b), _np(a), rtol=2**-6, atol=1e-5)
        else:
            np.testing.assert_allclose(_np(b), _np(a), rtol=1e-4, atol=1e-7)
    assert flips <= 0.01 * max(total, 1)


def test_train_state_shapes_equal_the_reference_eval_shape():
    """At stablelm-1.6b's full width, with f32 and quantized AdamW: meta
    tensors, nothing allocated."""
    jm, tm = jbuild(jget_arch("stablelm-1.6b")), tbuild(tget_arch("stablelm-1.6b"))
    for q in (False, True):
        js = jsteps.train_state_shapes(jm, jopt.adamw(1e-3, quantize=q))
        ts = tsteps.train_state_shapes(tm, topt.adamw(1e-3, quantize=q))
        jl, tl = jax.tree.leaves(js), tree_flatten(ts)[0]
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert b.device.type == "meta"
            assert tuple(b.shape) == a.shape and str(b.dtype).split(".")[-1] == a.dtype.name
        n = sum(t.numel() for t in tree_flatten(ts["params"])[0])
        nbytes = topt.state_nbytes(ts["opt"])
        assert n == 1_644_267_520
        assert nbytes == (4_958_494_240 if q else 13_154_140_160)


def test_init_train_state_on_the_generators_device():
    tm = tbuild(tget_arch("stablelm-1.6b").reduced())
    gen = torch.Generator().manual_seed(0)
    s = tsteps.init_train_state(tm, topt.adamw(1e-3), gen)
    assert s["step"].dtype == torch.int32 and int(s["step"]) == 0
    assert all(t.device.type == "cpu" for t in tree_flatten(s)[0])


# ---------------------------------------------------------------- data


def test_markov_tokens_equal_the_reference():
    src_j, src_t = jlm.MarkovTokens(1000, seed=3), MarkovTokens(1000, seed=3)
    np.testing.assert_array_equal(src_t.next_ids, src_j.next_ids)
    np.testing.assert_array_equal(src_t.probs, src_j.probs)
    jb, tb = jlm.token_batches(1000, 3, 50, seed=3), token_batches(1000, 3, 50, seed=3)
    for _ in range(3):
        a, b = next(jb), next(tb)
        assert b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(b["tokens"], a["tokens"])


# ---------------------------------------------------------------- CLI


def test_train_cli_checkpoints_resume_and_load_in_the_reference(tmp_path):
    ck = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--arch", "stablelm-1.6b", "--reduced", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-dir", ck, "--ckpt-every", "2"]
    state, log = ttrain.run(ttrain.parse_args(argv + ["--steps", "4"]))
    assert [e["step"] for e in log] == [1, 2, 3, 4]
    assert all(math.isfinite(e["loss"]) and e["ms_per_step"] > 0 for e in log)
    saved = tree_flatten(state)[0]
    port, meta = load_checkpoint(str(tmp_path / "ck" / "ckpt_00000004.msgpack.zst"), "cpu")
    assert meta["step"] == 4
    ref, jmeta = JCheckpointManager(ck).restore_latest()
    assert jmeta["step"] == 4
    assert len(jax.tree.leaves(ref)) == len(saved) == len(tree_flatten(port)[0])
    for a, b, c in zip(saved, tree_flatten(port)[0], jax.tree.leaves(ref)):
        assert b.dtype == a.dtype and torch.equal(a, b)
        np.testing.assert_array_equal(np.asarray(c), a.numpy())
    log2 = ttrain.main(argv + ["--steps", "6"])
    assert [e["step"] for e in log2] == [5, 6]
    assert all(math.isfinite(e["loss"]) for e in log2)


def test_train_cli_wants_a_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "1"])
