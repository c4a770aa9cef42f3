"""The port's MoE expert-parallel path against the reference's
``shard_map`` path, on the CPU.

The reference's path needs a mesh of eight devices, which a JAX process
has only when ``XLA_FLAGS`` forces them before JAX starts: it runs in one
child interpreter (``tests/_multidevice.run_multidevice``), which writes
each case's params, inputs and outputs to an ``.npz`` under ``tmp_path``.
The port runs the same params (through ``convert.py``) and inputs on a
mesh of ``["cpu"] * 8`` under ``util.use_mesh``.

Cases: kimi-k2 reduced on the reference test's own inputs
(``tests/test_distributed.py``: params of ``key(0)``, x of ``key(2)`` x
0.5, a (2, 4) ("data", "model") mesh); the same at capacity factor 0.5,
where every data shard drops pairs; arctic reduced (a dense residual MLP);
kimi-k2 on a (2, 2, 2) ("pod", "data", "model") mesh; and kimi-k2 in
bf16, where the branch weights the gate in bf16 (the local path in f32).

Tolerances: f32 ``out`` and ``aux`` rtol/atol 1e-5 (three f32 products of
width <= 256 and a K-way combine; the two packages sum in other orders);
bf16 atol 2e-2 against outputs of order 1 (bf16 keeps 8 bits; the two
packages round the expert products at different points), as
``tests/test_torch_moe.py``. Each case first asserts the reference's
smallest top-K margin is far above f32 rounding, so a flipped expert
reads as a fault.
"""

import numpy as np
import pytest
import torch

from _multidevice import run_multidevice
from repro.models import layers as jL
from repro_torch import convert, obs
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as tL
from repro_torch.util import use_mesh

# (name, arch, mesh dims, axes, capacity factor, dtype)
CASES = [
    ("kimi", "kimi-k2-1t-a32b", (2, 4), ("data", "model"), 1.25, "float32"),
    ("kimi_drops", "kimi-k2-1t-a32b", (2, 4), ("data", "model"), 0.5, "float32"),
    ("arctic", "arctic-480b", (2, 4), ("data", "model"), 1.25, "float32"),
    ("kimi_pods", "kimi-k2-1t-a32b", (2, 2, 2), ("pod", "data", "model"), 1.25, "float32"),
    ("kimi_bf16", "kimi-k2-1t-a32b", (2, 4), ("data", "model"), 1.25, "bfloat16"),
]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0, atol=2e-2)
MIN_MARGIN = 1e-5

_CHILD = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_arch
from repro.models import build_model
from repro.models.layers import moe_block
from repro.launch.mesh import make_mesh
from repro.util import use_mesh

for name, arch, dims, axes, cf, dtype in CASES:
    cfg = get_arch(arch).reduced().with_(param_dtype=dtype, compute_dtype=dtype)
    params = build_model(cfg).init(jax.random.key(0))
    x = (jax.random.normal(jax.random.key(2), (4, 16, cfg.d_model)) * 0.5).astype(dtype)
    moe_p = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    out_local, aux_local = moe_block(moe_p, x, cfg, capacity_factor=cf)
    with use_mesh(make_mesh(dims, axes)):
        out, aux = jax.jit(lambda p_, x_: moe_block(p_, x_, cfg, capacity_factor=cf))(moe_p, x)
    flat = {"p/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(moe_p)[0]}
    up = lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)
    np.savez(OUT + "/" + name + ".npz", x=up(x), out=up(out), aux=np.asarray(aux),
             out_local=up(out_local), aux_local=np.asarray(aux_local),
             **{k: (v.view(np.uint16) if v.dtype.name == "bfloat16" else v)
                for k, v in flat.items()})
    print(name, "ok")
"""


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_mesh")
    run_multidevice(f"CASES = {CASES!r}\nOUT = {str(out)!r}\n" + _CHILD)
    return out


def _load(ref_dir, name, dtype):
    z = np.load(ref_dir / f"{name}.npz")
    params = {}
    for k in z.files:
        if not k.startswith("p/"):
            continue
        a = z[k]
        if dtype == "bfloat16" and a.dtype == np.uint16:
            import ml_dtypes

            a = a.view(ml_dtypes.bfloat16)
        node, *rest = k[2:].split("/")
        if rest:
            params.setdefault(node, {})[rest[0]] = a
        else:
            params[node] = a
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(z["x"]).to(tdt)
    return z, convert.params_from_numpy(params, "cpu"), x


def _margin(x, router, K):
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).to(torch.float32) @ router, -1)
    top = probs.sort(-1, descending=True).values[:, : K + 1]
    return float((top[:, :-1] - top[:, 1:]).min())


def _cfg(arch, dtype):
    return get_arch(arch).reduced().with_(param_dtype=dtype, compute_dtype=dtype)


@pytest.mark.parametrize("name,arch,dims,axes,cf,dtype", CASES, ids=[c[0] for c in CASES])
def test_sharded_moe_equals_the_reference_shard_map(ref_dir, name, arch, dims, axes, cf, dtype):
    z, p, x = _load(ref_dir, name, dtype)
    cfg = _cfg(arch, dtype)
    assert _margin(x, p["router"], cfg.experts_per_token) > MIN_MARGIN
    mesh = make_mesh(dims, axes, devices=["cpu"] * 8)
    info = {"dp": int(np.prod(dims[:-1])), "mp": dims[-1]}
    T = x.shape[0] * x.shape[1]
    assert tL.moe_uses_shard_map(info, cfg.n_experts, cfg.experts_per_token, T)
    with obs.enabled() as tracer, use_mesh(mesh):
        out, aux = tL.moe_block(p, x, cfg, capacity_factor=cf)
    spans = [e for e in tracer.events if e.name == "moe_shard_map"]
    assert len(spans) == 1 and spans[0].args["dp"] == info["dp"]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert out.dtype == x.dtype
    np.testing.assert_allclose(out.to(torch.float32).numpy(), z["out"], **tol)
    np.testing.assert_allclose(float(aux), float(z["aux"]), **F32_TOL)
    # the local path is the reference's local path too
    lo, la = tL.moe_block(p, x, cfg, capacity_factor=cf)
    np.testing.assert_allclose(lo.to(torch.float32).numpy(), z["out_local"], **tol)
    np.testing.assert_allclose(float(la), float(z["aux_local"]), **F32_TOL)
    # the plain version is the branch bit for bit
    po, pa = tL.moe_sharded_plain(p, x, cfg, info["dp"], info["mp"], capacity_factor=cf)
    assert torch.equal(po, out) and torch.equal(pa, aux)


def test_capacity_drops_differ_between_the_paths(ref_dir):
    """At capacity 0.5 each data shard routes at its own capacity (C 8 of
    32 tokens, against 16 of 64 on one device), so the two paths drop
    different pairs, in both packages alike."""
    z, p, x = _load(ref_dir, "kimi_drops", "float32")
    cfg = _cfg("kimi-k2-1t-a32b", "float32")
    E, K = cfg.n_experts, cfg.experts_per_token
    xf = x.reshape(-1, cfg.d_model)
    keep_local = tL._route_local(xf, p["router"], E, K, max(1, int(64 * K / E * 0.5)))[3]
    keep_shards = torch.cat([tL._route_local(xf[i * 32:(i + 1) * 32], p["router"], E, K,
                                             max(1, int(32 * K / E * 0.5)))[3] for i in range(2)])
    assert not bool(keep_shards.all()) and not torch.equal(keep_local, keep_shards)
    assert np.abs(z["out"] - z["out_local"]).max() > 1e-3


def _kimi(seed=0, dtype="float32"):
    cfg = _cfg("kimi-k2-1t-a32b", dtype)
    gen = torch.Generator().manual_seed(seed)
    p = tL.init_moe(gen, cfg, getattr(torch, dtype), "cpu")
    x = torch.randn(4, 16, cfg.d_model, generator=gen).to(getattr(torch, dtype)) * 0.5
    return cfg, p, x


@pytest.mark.parametrize("dims,axes", [((2, 3), ("data", "model")), ((8, 1), ("data", "model")),
                                       ((2, 4), ("data", "expert")), ((3, 2), ("data", "model"))])
def test_no_expert_parallel_path_where_the_reference_takes_none(dims, axes):
    """E 4 over 3 model shards, a model axis of 1, no model axis, 64 tokens
    over 3 data shards: the local path, bit for bit the unmeshed block."""
    cfg, p, x = _kimi()
    want = tL.moe_block(p, x, cfg)
    mesh = make_mesh(dims, axes, devices=["cpu"] * int(np.prod(dims)))
    with obs.enabled() as tracer, use_mesh(mesh):
        got = tL.moe_block(p, x, cfg)
    assert "moe_shard_map" not in tracer.span_names()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_decode_shapes_take_the_local_path():
    """T_loc * K < E (the reference's decode rule): 2 tokens a data shard
    at top 2 against 8 experts take the local path."""
    cfg, p, x = _kimi()
    cfg = cfg.with_(n_experts=8)
    gen = torch.Generator().manual_seed(1)
    p = tL.init_moe(gen, cfg, torch.float32, "cpu")
    x = x[:, :1]  # 4 tokens, 2 a data shard: 2 * 2 < 8
    want = tL.moe_block(p, x, cfg)
    with obs.enabled() as tracer, use_mesh(make_mesh((2, 4), ("data", "model"),
                                                     devices=["cpu"] * 8)):
        got = tL.moe_block(p, x, cfg)
    assert "moe_shard_map" not in tracer.span_names()
    assert torch.equal(got[0], want[0])


def test_path_selection_equals_the_reference():
    """``moe_uses_shard_map`` on tests/test_moe_routing.py's cases and a
    grid of (dp, mp, E, K, T)."""
    def info(dp=16, mp=16):
        return {"sizes": {"data": dp, "model": mp}, "dp_axes": ("data",), "dp": dp, "mp": mp}

    cases = [(info(), 384, 8, 256 * 4096), (info(), 384, 8, 128), (None, 384, 8, 1 << 20),
             (info(mp=7), 384, 8, 1 << 20), (info(dp=16), 384, 8, 100)]
    for dp in (1, 2, 3, 16):
        for mp in (1, 2, 4, 7):
            for E in (4, 128, 384):
                for K in (1, 2, 8):
                    for T in (4, 64, 96, 1000, 8192):
                        cases.append((info(dp, mp), E, K, T))
    for c in cases:
        assert tL.moe_uses_shard_map(*c) == jL.moe_uses_shard_map(*c), c


def test_mesh_info_reads_the_ambient_mesh():
    assert tL._mesh_info() is None
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=["cpu"] * 8)
    with use_mesh(mesh):
        assert tL._mesh_info() == {"sizes": {"pod": 2, "data": 2, "model": 2},
                                   "dp_axes": ("pod", "data"), "dp": 4, "mp": 2}
    assert tL._mesh_info() is None


def test_the_branch_reads_placed_experts_and_never_copies_a_stack():
    """Expert leaves placed by the specs (``launch.sharding.place``) give
    the same result as views; a leaf on another device raises."""
    from repro_torch.launch import sharding as shd

    cfg, p, x = _kimi()
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    with use_mesh(mesh):
        want = tL.moe_block(p, x, cfg)
        specs = shd.tree_param_specs({"moe": p}, mesh, n_kv_heads=cfg.n_kv_heads)["moe"]
        placed = shd.place(p, shd.to_named(specs, mesh))
        assert placed["w_gate"].sharding.spec == shd.P("model", "data", None)
        got = tL.moe_block(placed, x, cfg)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        with pytest.raises(ValueError, match="place the expert weights"):
            tL.moe_block(dict(p, w_up=p["w_up"].to("meta")), x, cfg)


def test_the_branch_runs_on_meta_tensors():
    """The dry run's path: the branch on a mesh of meta devices."""
    cfg, p, x = _kimi()
    meta = {k: v.to("meta") for k, v in p.items()}
    with use_mesh(make_mesh((2, 4), ("data", "model"), devices=["meta"] * 8)):
        out, aux = tL.moe_block(meta, x.to("meta"), cfg)
    assert out.shape == x.shape and out.is_meta and aux.shape == ()
