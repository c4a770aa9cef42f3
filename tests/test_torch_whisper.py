"""Parity of the port's audio family (whisper, ``models/whisper.py``) with
the JAX reference, on the CPU: the sinusoidal positions, the encoder
(also at the full 1,500 frames, whose second 1,024-key chunk is padded),
the decoder, prefill (chunked, and with the flash kernel's plain version
against the reference's Pallas kernel in interpret mode), decode, prefill
+ decode against the full forward, the loss and its gradients, the cache
growth, ``ServeEngine`` (which decodes against the all-zero ``enc_out``,
as the reference's), ``launch/serve.py`` and ``launch/train.py``.

The same numpy inputs go through ``jax.jit`` of the reference and the
port; JAX params cross through ``convert.py``. Tolerances as
``tests/test_torch_ssm.py``: positions, encoder, decoder and logits
rtol/atol 1e-4, caches 1e-5, prefill + decode 2e-3 in log-softmax (the
reference's own test), bf16 logits within 3% of their largest magnitude,
the loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import whisper as jWH
from repro.models.registry import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch
from repro_torch.launch import serve as tserve
from repro_torch.models import whisper as tWH
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from test_torch_ssm import (GRAD_TOL, LOGIT_TOL, STATE_TOL, _models, _np, _tree_matches,
                            capture, engine_vs_reference, port_value_and_grad, serve_cli,
                            slot_isolation)

ARCH = "whisper-tiny"
ACT_TOL = dict(rtol=1e-4, atol=1e-4)


def _frames(cfg, B, seed, T=None):
    rng = np.random.RandomState(seed)
    return rng.randn(B, T or cfg.encoder_seq, cfg.frontend_dim).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("d", [64, 384])
def test_sinusoid_pos_equals_the_reference(d):
    """Positions up to 2,079 (a 2,048-token prompt and 32 decoded tokens):
    f32 sin/cos of such angles may differ by a few ulps between the two."""
    pos = np.stack([np.arange(2080), np.arange(2080)[::-1]]).astype(np.int32)
    want = jax.jit(lambda p: jWH.sinusoid_pos(p, d))(jnp.asarray(pos))
    got = tWH.sinusoid_pos(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == (2, 2080, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(d_model=64, frontend_dim=64, encoder_seq=1500)],
                         ids=["reduced", "1500-frames"])
def test_encode_equals_the_reference(kw):
    """At 1,500 frames the keys fill one 1,024-key chunk and a padded one:
    a mask that missed the padding would attend to 548 zero keys."""
    jm, tm, jp, tp = _models(ARCH, **kw)
    frames = _frames(jm.cfg, 2 if not kw else 1, 3)
    want = jax.jit(lambda p, f: jWH.encode(p, f, jm.cfg))(jp, frames)
    got = tWH.encode(tp, torch.from_numpy(frames), tm.cfg)
    assert got.shape == (frames.shape[0], jm.cfg.encoder_seq, jm.cfg.d_model)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ACT_TOL)


@pytest.mark.parametrize("attn_chunk", [1024, 16])
def test_decoder_forward_equals_the_reference(attn_chunk):
    """The decoder over 40 tokens against an encoder output of 32 frames,
    the cross-attention in one chunk and (at attn_chunk 16) over a padded
    query chunk and two key chunks; each layer's self-attention K/V too."""
    jm, tm, jp, tp = _models(ARCH, attn_chunk=attn_chunk)
    enc = np.random.RandomState(4).randn(2, jm.cfg.encoder_seq, jm.cfg.d_model).astype(
        np.float32)
    toks = _tokens(jm.cfg, 2, 40, 5)
    jx, jkv = jax.jit(lambda p, t, e: jWH.decoder_forward(p, t, e, jm.cfg))(jp, toks, enc)
    tx, tkv = tWH.decoder_forward(tp, torch.from_numpy(toks), torch.from_numpy(enc), tm.cfg)
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), **ACT_TOL)
    assert len(tkv) == tm.cfg.n_layers
    for i, (k, v) in enumerate(tkv):
        np.testing.assert_allclose(k.detach().numpy(), np.asarray(jkv[0][i]), **ACT_TOL)
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jkv[1][i]), **ACT_TOL)


# ---------------------------------------------------------------- the model


def test_full_width_param_tree_equals_the_reference():
    """Leaf names, shapes and dtypes at full width and depth against
    ``jax.eval_shape`` of the reference's init (the port's on meta
    tensors)."""
    want = jax.eval_shape(lambda: jbuild(jget_arch(ARCH)).init(jax.random.key(0)))
    got = tbuild(tget_arch(ARCH)).init(None, torch.device("meta"))
    assert _tree_matches(want, got) == (61_221_888, 122_443_776)


def test_convert_carries_the_reference_tree_unchanged():
    """The reference's whisper tree as numpy arrays (bf16 included) becomes
    the port's tree in the same structure, bit for bit, and back."""
    jcfg = jget_arch(ARCH).reduced().with_(param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(1)))
    tp = convert.params_from_numpy(jp, "cpu")
    assert set(tp) == {"frame_proj", "enc_layers", "enc_norm", "embed", "dec_layers",
                       "final_norm", "lm_head"}
    assert tp["dec_layers"]["cross_attn"]["wk"].shape == (2, 256, 256)
    back = convert.params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


def _close_cache(tc, jc):
    assert set(tc) == set(jc) == {"k", "v", "pos", "enc_out"}
    for n in tc:
        assert tuple(tc[n].shape) == tuple(jc[n].shape), n
        if n == "pos":
            np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))
        else:
            np.testing.assert_allclose(_np(tc[n]), _np(jc[n]), **STATE_TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_and_decode_equal_the_reference(flash):
    """Prefill (logits, K/V, positions, enc_out), grow the cache, 6 decode
    steps on the reference's greedy tokens; with the flash kernel the
    decoder's self-attention prefill runs its plain version here and the
    reference's Pallas kernel in interpret mode."""
    jm, tm, jp, tp = _models(ARCH, use_flash_kernel=flash, attn_chunk=16)
    B, P, gen = 2, 40 if not flash else 24, 6
    batch = {"frames": _frames(jm.cfg, B, 6), "tokens": _tokens(jm.cfg, B, P, 7)}
    jl, jc = jax.jit(jm.prefill)(jp, jax.tree.map(jnp.asarray, batch))
    tl, tc = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _close_cache(tc, jc)
    enc = tc["enc_out"]
    jc, tc = jm.grow_cache(jc, P + gen), tm.grow_cache(tc, P + gen)
    assert tc["k"].shape[2] == P + gen and tc["enc_out"] is enc
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
    """``cache_len_for``, ``decode_window_for`` and ``init_cache`` (the
    all-zero ``enc_out`` of ``encoder_seq`` frames)."""
    jm, tm, _, _ = _models(ARCH)
    for n in (16, 32_768, 40_000):
        assert tm.cache_len_for(n) == jm.cache_len_for(n)
        assert tm.decode_window_for(n) == jm.decode_window_for(n)
    tc, jc = tm.init_cache(3, 10, "cpu"), jm.init_cache(3, 10)
    _close_cache(tc, jc)
    assert not tc["enc_out"].any() and tc["enc_out"].shape == (3, 32, 256)


def test_prefill_decode_equals_full_forward():
    """The reference's ``test_whisper_prefill_decode_consistency``: prefill
    on S tokens then decode token S gives the full decoder forward's
    next-token log-softmax within rtol/atol 2e-3."""
    jm, tm, jp, tp = _models(ARCH)
    cfg = jm.cfg
    B, S_ = 2, 12
    frames = np.full((B, cfg.encoder_seq, cfg.frontend_dim), 0.1, np.float32)
    tokens = _tokens(cfg, B, S_ + 1, 3)

    def full(p, f, t):
        x, _ = jWH.decoder_forward(p, t, jWH.encode(p, f, cfg), cfg)
        return (x[:, -1] @ p["lm_head"]).astype(jnp.float32)

    want = jax.jit(full)(jp, frames, tokens)
    _, cache = tm.prefill(tp, {"frames": torch.from_numpy(frames),
                               "tokens": torch.from_numpy(tokens[:, :S_])})
    cache = tm.grow_cache(cache, S_ + 1)
    got, _ = tm.decode(tp, cache, {"tokens": torch.from_numpy(tokens[:, S_:]),
                                   "pos": torch.full((B,), S_, dtype=torch.int32)})
    np.testing.assert_allclose(torch.log_softmax(got, -1).numpy(),
                               np.asarray(jax.nn.log_softmax(want)), rtol=2e-3, atol=2e-3)


def test_prefill_bf16_equals_the_reference():
    """bf16 params and compute: logits within 3% of their largest
    magnitude; the K/V and enc_out bf16."""
    jm, tm, jp, tp = _models(ARCH, param_dtype="bfloat16", compute_dtype="bfloat16")
    batch = {"frames": _frames(jm.cfg, 2, 8), "tokens": _tokens(jm.cfg, 2, 40, 8)}
    jl, _ = jax.jit(jm.prefill)(jp, jax.tree.map(jnp.asarray, batch))
    tl, tc = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tc["k"].dtype == tc["enc_out"].dtype == torch.bfloat16
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=0.03 * np.abs(jl).max())


def test_loss_and_grads_equal_the_reference():
    """``whisper_loss`` rtol 1e-5 and every gradient (the encoder's through
    the cross-attention) against ``jax.value_and_grad`` of the jitted
    reference."""
    jm, tm, jp, tp = _models(ARCH, attn_chunk=16)
    batch = {"frames": _frames(jm.cfg, 2, 9), "tokens": _tokens(jm.cfg, 2, 20, 10)}
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    tl, tmet, tg = port_value_and_grad(tm, tp, {k: torch.from_numpy(v)
                                                for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tmet["ce"]) == float(tl) and float(tmet["aux"]) == 0.0
    jg = jax.tree.leaves(jg)
    assert len(tg) == len(jg)
    assert float(np.abs(np.asarray(jg[0])).max()) > 0  # the encoder is trained
    for a, g in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), **GRAD_TOL)


def test_grow_cache_keeps_enc_out():
    """K/V padded with zeros and positions with -1; ``enc_out`` is the
    same tensor, as the reference leaves it."""
    _, tm, _, _ = _models(ARCH)
    cache = tm.init_cache(2, 5, "cpu")
    cache["enc_out"].normal_(generator=torch.Generator().manual_seed(0))
    grown = tm.grow_cache(cache, 9)
    assert grown["enc_out"] is cache["enc_out"]
    assert grown["k"].shape == (2, 2, 9, 4, 64) and grown["pos"].shape == (2, 2, 9)
    assert bool((grown["pos"][..., 5:] == -1).all()) and not grown["k"][:, :, 5:].any()


# ---------------------------------------------------------------- serving


def test_engine_matches_reference():
    """Both engines decode against the all-zero ``enc_out`` of
    ``init_whisper_cache`` (neither encodes): equal logits and greedy ids
    while the tokens agree away from a near tie."""
    engine_vs_reference(ARCH)


def test_engine_slot_reset_isolates_requests():
    slot_isolation(ARCH)


def test_engine_slot_reset_leaves_enc_out():
    """The in-place slot reset clears the slot's K/V/pos and leaves
    ``enc_out`` as it is, as the reference's reset copies it unchanged;
    a drained engine's ``enc_out`` is still all zero."""
    cfg = tget_arch(ARCH).reduced()
    eng = TServeEngine(cfg, max_batch=2, cache_len=16, device="cpu")
    for name in ("k", "v", "enc_out"):
        eng.cache[name].normal_(generator=torch.Generator().manual_seed(1))
    enc = eng.cache["enc_out"].clone()
    eng._reset_slot_cache(1)
    assert torch.equal(eng.cache["enc_out"], enc)
    assert not eng.cache["k"][:, 1].any() and bool((eng.cache["pos"][:, 1] == -1).all())
    assert eng.cache["k"][:, 0].any()

    eng = TServeEngine(cfg, max_batch=2, cache_len=32, device="cpu")
    logs = capture(eng)
    for i in range(3):
        eng.submit(TRequest(i, np.arange(1, 5 + i, dtype=np.int32), max_new_tokens=4))
    assert len(eng.run_until_drained()) == 3 and len(logs) > 0
    assert not eng.cache["enc_out"].any()


def test_launch_serve_matches_reference_flow():
    """The reference's serve flow: frames drawn from the same RandomState
    right after the prompts; the prefill logits and the cache grown to P +
    gen, ``enc_out`` kept."""
    jm, _, jp, tp = _models(ARCH)
    B, P, gen, seed = 2, 16, 4, 3
    res = tserve.serve(tget_arch(ARCH).reduced(), batch=B, prompt_len=P, gen=gen, seed=seed,
                       device="cpu", params=tp)
    rng = np.random.RandomState(seed)
    prompts = rng.randint(0, jm.cfg.vocab_size, (B, P))
    frames = rng.randn(B, jm.cfg.encoder_seq, jm.cfg.frontend_dim).astype(np.float32)
    np.testing.assert_array_equal(res.prompts, prompts)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompts, jnp.int32),
                                      "frames": jnp.asarray(frames)})
    np.testing.assert_allclose(res.prefill_logits.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(res.cache["enc_out"].numpy(), np.asarray(jc["enc_out"]),
                               **STATE_TOL)
    assert res.tokens.shape == (B, gen) and res.all_finite
    assert res.cache["k"].shape[2] == P + gen


def test_serve_cli_on_cpu():
    serve_cli(ARCH)


def test_train_steps_feed_the_reference_frames():
    """Two steps of ``launch.train.run``: step i's batch holds
    ``RandomState(i)`` frames beside the token stream's batch i, and the
    logged loss equals the reference's jitted ``whisper_loss`` on the
    params that step started from."""
    from repro_torch.launch import train as ttrain

    seen = []
    make = ttrain.make_train_step

    def recording(model, opt):
        step = make(model, opt)

        def wrapped(state, batch):
            seen.append((convert.params_to_numpy(state["params"]),
                         {k: v.numpy().copy() for k, v in batch.items()}))
            return step(state, batch)

        return wrapped

    ttrain.make_train_step = recording
    try:
        _, log = ttrain.run(ttrain.parse_args([
            "--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--log-every", "1"]))
    finally:
        ttrain.make_train_step = make
    cfg = jget_arch(ARCH).reduced()
    loss = jax.jit(lambda p, b: jWH.whisper_loss(p, b, cfg)[0])
    assert [e["step"] for e in log] == [1, 2] and len(seen) == 2
    for i, (params, batch) in enumerate(seen):
        want = np.random.RandomState(i).randn(2, cfg.encoder_seq, cfg.frontend_dim)
        np.testing.assert_array_equal(batch["frames"], want.astype(np.float32))
        assert batch["tokens"].shape == (2, 16)
        np.testing.assert_allclose(log[i]["loss"], float(loss(params, batch)), rtol=1e-5)


def test_reference_config_fields_are_equal():
    """Every field, full and reduced (the encoder branch: 2 layers of 32
    frames), and the assigned architectures."""
    for j, t in ((jget_arch(ARCH), tget_arch(ARCH)),
                 (jget_arch(ARCH).reduced(), tget_arch(ARCH).reduced())):
        assert set(t.__dataclass_fields__) <= set(j.__dataclass_fields__)
        for f in t.__dataclass_fields__:
            assert getattr(t, f) == getattr(j, f), f
    assert (tget_arch(ARCH).reduced().encoder_layers, tget_arch(ARCH).reduced().encoder_seq) \
        == (2, 32)
    from repro.configs.all_archs import ASSIGNED_ARCHS

    assert tconfigs.ASSIGNED_ARCHS == ASSIGNED_ARCHS
    assert all(tbuild(tget_arch(a)).cfg.name == a for a in ASSIGNED_ARCHS)
