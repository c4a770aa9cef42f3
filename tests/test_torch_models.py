"""Parity of the port's dense-LM layers and its flash attention with the
JAX reference, on the CPU, in f32, at the reduced widths of the two dense
serving configs: ``stablelm-1.6b`` (MHA) and ``qwen3-8b`` with 2 KV heads
(``reduced()`` alone gives 4 KV heads for 4 query heads and loses GQA).

The same numpy inputs go through the JAX function and its port; JAX params
cross to the port through ``convert.py``. Single layers agree within
rtol/atol 1e-5 (f32, summation order only). The port's ``flash_mha`` on
CPU tensors is the plain version of the CUDA kernel; it is held against
``repro.kernels.ops.flash_mha`` (the Pallas kernel in interpret mode) and
``ref.flash_attention_ref``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jL
from repro.models import transformer as jTF
from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import layers as tL

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(name):
    """(jax cfg, port cfg) of a reduced serving config."""
    j, t = jget_arch(name).reduced(), tget_arch(name).reduced()
    if name == "qwen3-8b":
        j, t = j.with_(n_kv_heads=2), t.with_(n_kv_heads=2)
    return j, t


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


ARCHS = ["stablelm-1.6b", "qwen3-8b"]


def test_port_configs_match_reference():
    for name in (*ARCHS, "kimi-k2-1t-a32b", "arctic-480b", "qwen2-vl-2b"):
        j, t = jget_arch(name), tget_arch(name)
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "qk_norm", "qkv_bias", "rope_theta", "tie_embeddings",
                  "norm_eps", "window", "attn_chunk", "use_flash_kernel", "param_dtype",
                  "compute_dtype", "source", "remat", "n_experts", "experts_per_token",
                  "moe_d_ff", "dense_residual", "router_aux_coef", "mrope", "mrope_sections",
                  "frontend", "frontend_dim"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert j.resolved_head_dim() == t.resolved_head_dim()
        jr, tr = j.reduced(), t.reduced()
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "head_dim", "window", "param_dtype", "n_experts",
                  "experts_per_token", "moe_d_ff", "mrope_sections", "frontend_dim"):
            assert getattr(jr, f) == getattr(tr, f), (name, f)
    # the DeepSpeech2 config keeps the reference's attention defaults
    ds2 = tget_arch("deepspeech2")
    assert (ds2.n_heads, ds2.n_kv_heads, ds2.d_ff, ds2.use_flash_kernel) == (1, 1, 0, False)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 7, 4, 32)])
def test_rms_norm(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32) * 3
    w = rng.randn(shape[-1]).astype(np.float32)
    want = np.asarray(jL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = tL.rms_norm(_t(x), _t(w), 1e-6).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0, 0.0])
def test_apply_rope(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 4, 32).astype(np.float32)
    pos = rng.randint(0, 3000, (2, 9)).astype(np.int32)
    want = np.asarray(jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tL.apply_rope(_t(x), _t(pos), theta).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        tL.rope_freqs(32, 1e6).numpy(), np.asarray(jL.rope_freqs(32, 1e6)), rtol=1e-6)


def _qkv(rng, B, S, H, KV, D):
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, KV, D).astype(np.float32)
    v = rng.randn(B, S, KV, D).astype(np.float32)
    return q, k, v


# (causal, window): the dynamic-skip branch (prefill), the windowed masked
# full scan, and the non-causal masked full scan
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
@pytest.mark.parametrize("S,KV", [(40, 2), (33, 4), (16, 1)])
def test_chunked_attention(causal, window, S, KV):
    rng = np.random.RandomState(S + KV)
    q, k, v = _qkv(rng, 2, S, 4, KV, 16)
    want = np.asarray(jL.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
        q_chunk=16, k_chunk=16, differentiable=False))
    got = tL.chunked_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                               q_chunk=16, k_chunk=16).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("KV", [4, 2])
def test_decode_attention_ring_buffer(window, KV):
    rng = np.random.RandomState(7)
    B, W, H, D = 3, 24, 4, 16
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kc = rng.randn(B, W, KV, D).astype(np.float32)
    vc = rng.randn(B, W, KV, D).astype(np.float32)
    # slot b holds positions of a ring that wrapped (some empty slots)
    pos = np.array([5, 30, 47], np.int32)
    cpos = np.full((B, W), -1, np.int32)
    for b in range(B):
        for p in range(pos[b] + 1):
            cpos[b, p % W] = p
    want = np.asarray(jL.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                          jnp.asarray(cpos), jnp.asarray(pos), window=window))
    got = tL.decode_attention(_t(q), _t(kc), _t(vc), _t(cpos), _t(pos).long(),
                              window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _attn_params(jcfg, seed=0):
    p = _np(jL.init_attention(jax.random.key(seed), jcfg, jnp.float32))
    return p, convert.params_from_numpy(p, "cpu")


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_block(arch, flash):
    jcfg, tcfg = _cfgs(arch)
    jcfg, tcfg = (c.with_(use_flash_kernel=flash, attn_chunk=16) for c in (jcfg, tcfg))
    jp, tp = _attn_params(jcfg)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    jout, (jk, jv) = jL.attention_block(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                        differentiable=False)
    tout, (tk, tv) = tL.attention_block(tp, _t(x), tcfg, _t(pos), differentiable=False)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_decode_block(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _attn_params(jcfg, seed=1)
    rng = np.random.RandomState(4)
    B, W = 2, 12
    KV, Dh = jcfg.n_kv_heads, jcfg.resolved_head_dim()
    x = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
    cache = {"k": rng.randn(B, W, KV, Dh).astype(np.float32),
             "v": rng.randn(B, W, KV, Dh).astype(np.float32),
             "pos": np.where(np.arange(W)[None] < np.array([[5], [12]]),
                             np.arange(W)[None], -1).astype(np.int32)}
    pos = np.array([5, 14], np.int32)
    jout, jc = jL.attention_decode_block(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                         jax.tree.map(jnp.asarray, cache), window=8)
    tout, tc = tL.attention_decode_block(tp, _t(x), tcfg, _t(pos).long(),
                                         {n: _t(a) for n, a in cache.items()}, window=8)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_mlp_block(arch):
    jcfg, _ = _cfgs(arch)
    jp = _np(jL.init_mlp(jax.random.key(2), jcfg.d_model, jcfg.d_ff, jnp.float32))
    tp = convert.params_from_numpy(jp, "cpu")
    x = np.random.RandomState(5).randn(2, 6, jcfg.d_model).astype(np.float32)
    want = np.asarray(jL.mlp_block(jp, jnp.asarray(x)))
    got = tL.mlp_block(tp, _t(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("KV", [4, 2, 1])
@pytest.mark.parametrize("S", [24, 128, 200])
def test_flash_mha_plain_matches_pallas_and_ref(S, KV, D):
    """The port's flash_mha on CPU tensors (the kernel's plain version)
    against the Pallas kernel in interpret mode and the naive reference."""
    H = 4
    rng = np.random.RandomState(S * 10 + KV + D)
    q, k, v = _qkv(rng, 2, S, H, KV, D)
    got = kfa.flash_mha(_t(q), _t(k), _t(v)).numpy()
    want = np.asarray(jops.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, **TOL)
    G = H // KV
    fold = lambda a: a.transpose(0, 2, 1, 3).reshape(-1, S, D)  # noqa: E731
    naive = np.asarray(jref.flash_attention_ref(
        fold(q), fold(np.repeat(k, G, axis=2)), fold(np.repeat(v, G, axis=2))))
    np.testing.assert_allclose(got, naive.reshape(2, H, S, D).transpose(0, 2, 1, 3), **TOL)


def test_flash_plain_rounds_p_to_the_value_dtype():
    """bf16 inputs: the plain version rounds p to bf16 before PV, as the
    TPU kernel does; against the Pallas kernel (interpret) in bf16 the
    outputs agree to a bf16 ulp."""
    rng = np.random.RandomState(11)
    q, k, v = _qkv(rng, 1, 130, 4, 2, 64)
    bf = lambda a: a.astype(ml_dtypes.bfloat16)  # noqa: E731
    want = np.asarray(jops.flash_mha(jnp.asarray(bf(q)), jnp.asarray(bf(k)),
                                     jnp.asarray(bf(v)))).astype(np.float32)
    conv = lambda a: convert.params_from_numpy(bf(a), "cpu")  # noqa: E731
    got = kfa.flash_mha(conv(q), conv(k), conv(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=2**-7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_mismatch_bounds_each_element_and_the_share(dtype):
    """The kernel-vs-plain tolerance: ulps of each element's own magnitude
    plus a small absolute term, and a bound on the share that differ."""
    eps = torch.finfo(dtype).eps
    x = torch.tensor([1.0, 1.5, 0.75, -3.0, 0.0])
    want = torch.tensor([eps, eps, eps / 2, 2 * eps, eps * torch.finfo(dtype).tiny])
    assert torch.equal(kfa.ulp(x, dtype), want)
    rng = np.random.RandomState(5)
    plain = torch.from_numpy(rng.randn(1, 200, 2, 64).astype(np.float32)).to(dtype)
    ok = kfa.mismatch(plain.clone(), plain)
    assert ok["within"] and ok["share_differing"] == 0.0 and ok["over_element_bound"] == 0
    flat = plain.float().flatten()
    u = kfa.ulp(flat, dtype)
    one = flat.clone()  # one element beyond the bound
    one[7] += kfa.TOL_ULPS * u[7] + 2 * kfa.TOL_ATOL[dtype] + 1e-3
    bad = kfa.mismatch(one.reshape(plain.shape).to(dtype), plain)
    assert bad["over_element_bound"] == 1 and not bad["within"]
    if kfa.TOL_SHARE[dtype] < 1.0:  # many elements each one ulp off
        n = int(flat.numel() * kfa.TOL_SHARE[dtype] * 2)
        many = flat.clone()
        many[:n] += u[:n]
        r = kfa.mismatch(many.reshape(plain.shape).to(dtype), plain)
        assert r["over_element_bound"] == 0 and r["share_differing"] > kfa.TOL_SHARE[dtype]
        assert not r["within"]


def test_flash_on_cpu_does_not_count_launches():
    before = kfa.flash_mha.launches
    z = torch.randn(1, 8, 2, 64)
    kfa.flash_mha(z, z, z)
    assert kfa.flash_mha.launches == before


def test_convert_bf16_round_trip_bit_for_bit():
    """A JAX bf16 param tree crosses to the port and back bit for bit."""
    cfg = jget_arch("qwen3-8b").reduced().with_(param_dtype="bfloat16", n_layers=1)
    jp = _np(jTF.init_lm(jax.random.key(0), cfg))
    tp = convert.params_from_numpy(jp, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  jp["embed"].astype(np.float32))
    back = convert.params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert b.dtype == a.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


def test_convert_other_dtypes_unchanged():
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": [np.linspace(0, 1, 5, dtype=np.float32)]}
    t = convert.params_from_numpy(tree, "cpu")
    assert t["a"].dtype == torch.int32 and t["b"][0].dtype == torch.float32
    back = convert.params_to_numpy(t)
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"][0], tree["b"][0])
