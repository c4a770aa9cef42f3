"""The port's sharded train step (``launch.steps.make_sharded_train_step``)
on the CPU: meshes of repeated ``"cpu"`` devices, one process driving
every shard.

What it must equal:

- on a (1, 1) mesh, ``make_train_step`` bit for bit (state and metrics);
- on any other mesh, the port's unsharded step run under ``use_mesh`` of
  the same mesh (so an MoE takes the same branch at the same per-shard
  capacity), within the tolerances below;
- the reference's own sharded step, ``jax.jit(make_train_step,
  in_shardings=...)`` on a (2, 4) mesh of 8 forced host devices, run in one
  child interpreter (``tests/_multidevice.run_multidevice``) on the same
  numpy params (``convert.params_from_numpy``) and batch: qwen3-8b reduced
  as ``tests/test_distributed.py`` runs it, the same with quantized AdamW
  moments, and kimi-k2 reduced with remat on a batch that takes the MoE's
  expert-parallel branch.

Tolerances (f32; each worst leaf's ``max |a - b| / max |b|``), with the
readings they were set from and a planted fault each must catch (one data
shard's gradient dropped; the mean of the shards' means under an uneven
mask):

- metrics (loss, ce, aux, grad_norm) rtol 1e-6: readings up to 2.1e-7
  (the reference's kimi loss), faults 1.8e-2 (loss) and 0.10-0.28
  (grad_norm);
- f32 moments 1e-5: readings up to 3.0e-6, faults 0.75 and more;
- params 1e-3 over the informative elements. Adam's first step divides
  each moment by its root, so an element whose gradient is rounding noise
  of the shard sums moves by up to its lr either way, the sign set by the
  noise: read over every element, the tensor-parallel route's readings
  reached 1.72e-3 on some CPUs. So under Adam the reading sets aside the
  elements whose reference ``|m|`` is not 0 and under ``NOISE_M`` = 1e-3
  of the leaf's RMS ``|m|``, at most ``NOISE_SHARE`` = 1% of the elements,
  and holds each of those to the most one step moves it, 2 lr (1 + wd
  |p|). Readings: informative up to 2.1e-5, set aside up to 0.40% of the
  elements and 0.11 of a step's move; faults 2.2e-2 to 2.3e-2;
- bf16 moments (quantized AdamW, bf16 momentum) 2^-7, one bf16 rounding:
  readings up to 4.0e-3, fault 1.02; int8 ``v_q`` at most one symbol
  apart on at most 1% of the symbols (readings 1 and 0.004%), as
  ``tests/test_torch_train.py``.

The reference's own test holds its sharded step to 1e-2 (loss) and 5e-2
(params) of its unsharded one.
"""

import math

import numpy as np
import pytest
import torch

from _multidevice import run_multidevice
from repro_torch import convert, obs
from repro_torch.configs import get_arch
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as tL
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw, momentum, sgd
from repro_torch.util import use_mesh

METRIC_RTOL = 1e-6
MOMENT_RTOL = 1e-5
PARAM_RTOL = 1e-3
BF16_MOMENT_RTOL = 2.0 ** -7
VQ_SHARE = 0.01
# Adam's params reading sets aside the elements whose reference |m| is under
# NOISE_M of the leaf's RMS |m| (at most NOISE_SHARE of the elements) and
# holds each to the most one step of adamw(ADAM_LR) moves it
NOISE_M = 1e-3
NOISE_SHARE = 0.01
ADAM_LR, ADAM_WD = 1e-3, 0.01

MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["2x4", "4x2", "1x4", "2x2x2"]

# (name, arch, config overrides, quantized moments): the reference's cases
REF_CASES = [("qwen3", "qwen3-8b", {}, False), ("qwen3_quant", "qwen3-8b", {}, True),
             ("kimi", "kimi-k2-1t-a32b", {"remat": True}, False)]

_CHILD = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_arch
from repro.models import build_model
from repro.launch.steps import make_train_step
from repro.launch import sharding as shd
from repro.launch.mesh import make_mesh
from repro.optim import adamw
from repro.util import use_mesh

def key(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)

for name, arch, kw, quant in CASES:
    cfg = get_arch(arch).reduced().with_(**kw)
    model = build_model(cfg)
    opt = adamw(1e-3, quantize=quant)
    params = model.init(jax.random.key(0))
    state = {"params": params, "opt": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    batch = {"tokens": jax.random.randint(jax.random.key(1), (4, 16), 0, cfg.vocab_size)}
    mesh = make_mesh((2, 4), ("data", "model"))
    shapes = jax.eval_shape(lambda: state)
    specs = {"params": shd.tree_param_specs(shapes["params"], mesh, n_kv_heads=cfg.n_kv_heads),
             "opt": {k: shd.tree_param_specs(v, mesh, n_kv_heads=cfg.n_kv_heads)
                     for k, v in shapes["opt"].items()},
             "step": jax.sharding.PartitionSpec()}
    bspecs = shd.batch_spec({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                             for k, v in batch.items()}, mesh)
    with use_mesh(mesh):
        step = jax.jit(make_train_step(model, opt),
                       in_shardings=(shd.to_named(specs, mesh), shd.to_named(bspecs, mesh)))
        new, metrics = step(jax.device_put(state, shd.to_named(specs, mesh)),
                            jax.device_put(batch, shd.to_named(bspecs, mesh)))
    up = lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)
    out = {"tokens": np.asarray(batch["tokens"])}
    out.update({"p/" + key(path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(params)[0]})
    out.update({f"s/{i:04d}": up(v) for i, v in enumerate(jax.tree.leaves(new))})
    out.update({"m/" + k: np.asarray(v) for k, v in metrics.items()})
    np.savez(OUT + "/" + name + ".npz", **out)
    print(name, "ok")
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the step's many small ops on
    tiny tensors otherwise wait on the thread pool's barriers, which the
    suite's parallel workers make slow (8 cores: 30 of these tests took
    404 s beside five busy processes at the default count, 108 s at one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_train")
    run_multidevice(f"CASES = {REF_CASES!r}\nOUT = {str(out)!r}\n" + _CHILD)
    return out


# ---------------------------------------------------------------- helpers


def _mesh(dims, axes):
    return make_mesh(dims, axes, devices=["cpu"] * math.prod(dims))


def _cfg(arch, **kw):
    return get_arch(arch).reduced().with_(**kw)


def _batch(cfg, B=4, S=16, seed=0, mask=None):
    rng = np.random.RandomState(seed)
    batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, S)),
                                       dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = torch.as_tensor(rng.randn(B, 4, cfg.frontend_dim).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(
            rng.randn(B, cfg.encoder_seq, cfg.frontend_dim).astype(np.float32))
    if mask is not None:
        batch["mask"] = torch.as_tensor(mask)
    return batch


def _shardings(cfg, state, batch, mesh):
    specs = {"params": shd.tree_param_specs(state["params"], mesh, n_kv_heads=cfg.n_kv_heads),
             "opt": {k: shd.tree_param_specs(v, mesh, n_kv_heads=cfg.n_kv_heads)
                     for k, v in state["opt"].items()},
             "step": shd.P()}
    return shd.to_named(specs, mesh), shd.to_named(shd.batch_spec(batch, mesh), mesh)


def _setup(arch, dims, axes, opt=None, params=None, **kw):
    cfg = _cfg(arch, **kw)
    model = build_model(cfg)
    opt = opt or adamw(1e-3)
    if params is None:
        state = steps.init_train_state(model, opt, torch.Generator().manual_seed(0))
    else:
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
    return cfg, model, opt, state, _mesh(dims, axes)


def _sharded(model, opt, state, batch, mesh, cfg):
    s_sh, b_sh = _shardings(cfg, state, batch, mesh)
    return steps.make_sharded_train_step(model, opt, s_sh, b_sh)(state, batch)


def _unsharded(model, opt, state, batch, mesh):
    with use_mesh(mesh):
        return steps.make_train_step(model, opt)(state, batch)


def _groups(state):
    """(group name, leaves) of a train state: params, each opt entry, step."""
    out = [("params", tree_leaves(state["params"]))]
    out += [(name, tree_leaves(sub)) for name, sub in sorted(state["opt"].items())]
    return out + [("step", [state["step"]])]


def _noise(m, p):
    """The elements of a param leaf whose reference first moment ``m`` is
    not 0 and under NOISE_M of the leaf's RMS |m|: their gradient is
    rounding noise of the shard sums. An exact 0 (an embedding row no token
    reads) is no noise, and none where ``m`` is not the leaf's shape."""
    if m.shape != p.shape:
        return torch.zeros(p.shape, dtype=torch.bool)
    m = m.double().abs()
    return (m > 0) & (m < NOISE_M * float(m.square().mean().sqrt()))


def _param_readings(a_leaves, b_leaves, m_leaves):
    """The params' reading over the informative elements (worst max|a - b|
    / max|b| of a leaf), and over the noise elements (their share, and the
    largest |a - b| in units of the most one Adam step moves an element,
    2 lr (1 + wd |p|))."""
    worst, held, n_noise, n_all = 0.0, 0.0, 0, 0
    for a, b, m in zip(a_leaves, b_leaves, m_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype, ("params", a.shape, b.shape)
        a, b = a.double(), b.double()
        d, noise = (a - b).abs(), _noise(m, b)
        worst = max(worst, float(torch.where(noise, 0.0, d).max()) / max(float(b.abs().max()), 1e-30))
        step = 2 * ADAM_LR * (1 + ADAM_WD * b.abs())
        held = max(held, float(torch.where(noise, d / step, 0.0).max()))
        n_noise, n_all = n_noise + int(noise.sum()), n_all + noise.numel()
    return worst, (n_noise / n_all, held)


def _readings(got, want):
    """{group: worst max|a - b| / max|b|}; for ``v_q`` (largest symbol
    difference, share of symbols that differ). Under Adam, ``params`` reads
    only the informative elements and ``params_noise`` the others (share,
    largest |a - b| over one step's move; ``_param_readings``)."""
    out = {}
    adam = "m" in want["opt"] and ("v" in want["opt"] or "v_q" in want["opt"])
    for (name, a_leaves), (_, b_leaves) in zip(_groups(got), _groups(want)):
        assert len(a_leaves) == len(b_leaves)
        if name == "v_q":
            diffs = [(a.to(torch.int32) - b.to(torch.int32)).abs() for a, b in zip(a_leaves, b_leaves)]
            out[name] = (max(int(d.max()) for d in diffs),
                         sum(int((d > 0).sum()) for d in diffs) / sum(d.numel() for d in diffs))
            continue
        if name == "params" and adam:
            out[name], out["params_noise"] = _param_readings(a_leaves, b_leaves,
                                                             tree_leaves(want["opt"]["m"]))
            continue
        worst = 0.0
        for a, b in zip(a_leaves, b_leaves):
            assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape)
            a, b = a.double(), b.double()
            worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
        out[name] = worst
    return out


def _within(got, want, got_m, want_m, bf16_m=False):
    """The readings, and whether each is within its tolerance."""
    r = _readings(got, want)
    rm = {k: abs(float(got_m[k]) - float(want_m[k])) / max(abs(float(want_m[k])), 1e-30)
          for k in want_m}
    tol = {"params": PARAM_RTOL, "m": BF16_MOMENT_RTOL if bf16_m else MOMENT_RTOL,
           "v": MOMENT_RTOL, "v_scale": MOMENT_RTOL, "step": 0.0}
    ok = all(v <= tol[k] for k, v in r.items() if k not in ("v_q", "params_noise"))
    if "v_q" in r:
        ok &= r["v_q"][0] <= 1 and r["v_q"][1] <= VQ_SHARE
    if "params_noise" in r:
        ok &= r["params_noise"][0] <= NOISE_SHARE and r["params_noise"][1] <= 1.0
    ok &= all(v <= METRIC_RTOL for v in rm.values())
    return ok, r, rm


def _assert_layout(new, state, shardings):
    """The new state's pieces keep each old piece's shape, dtype and
    device, and each device's bytes are the specs' reckoning."""
    placed = steps._placed({k: state[k] for k in ("params", "opt", "step")}, shardings)
    for a, b in zip(tree_leaves(new), tree_leaves(placed)):
        assert isinstance(a, shd.Placed) and a.sharding is b.sharding
        assert a.shape == b.shape and a.dtype == b.dtype
        for p, q in zip(a.pieces.flat, b.pieces.flat):
            assert (p.shape, p.dtype, p.device) == (q.shape, q.dtype, q.device)
    assert (shd.device_nbytes(new) == shd.device_nbytes(placed)).all()


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


class _DropShard:
    """Planted fault: data shard ``k``'s gradient replaced by zeros."""

    def __init__(self, monkeypatch, k=1):
        self.calls, real = 0, steps._forward_backward

        def fb(*a, **kw):
            loss, metrics, grads = real(*a, **kw)
            self.calls += 1
            if self.calls == k + 1:
                grads = [(i, box, torch.zeros_like(g)) for i, box, g in grads]
            return loss, metrics, grads

        monkeypatch.setattr(steps, "_forward_backward", fb)


# ---------------------------------------------------------------- (1, 1)


@pytest.mark.parametrize("arch,kw,quant", [("qwen3-8b", {}, False), ("qwen3-8b", {}, True),
                                           ("kimi-k2-1t-a32b", {"remat": True}, False)],
                         ids=["qwen3", "qwen3_quant", "kimi_remat"])
def test_one_by_one_mesh_is_make_train_step_bit_for_bit(arch, kw, quant):
    cfg, model, opt, state, mesh = _setup(arch, (1, 1), ("data", "model"),
                                          adamw(1e-3, quantize=quant), **kw)
    batch = _batch(cfg)
    new, met = _sharded(model, opt, state, batch, mesh, cfg)
    want, want_m = steps.make_train_step(model, opt)(state, batch)
    for a, b in zip(tree_leaves(shd.gather(new)), tree_leaves(want)):
        assert _bits_equal(a, b)
    assert list(met) == list(want_m)
    assert all(_bits_equal(met[k], want_m[k]) for k in met)


# ------------------------------------------------- against the unsharded step


@pytest.mark.parametrize("dims,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch,kw", [("qwen3-8b", {}), ("kimi-k2-1t-a32b", {"remat": True})],
                         ids=["qwen3", "kimi_remat"])
def test_sharded_step_matches_the_unsharded_step_under_the_mesh(arch, kw, dims, axes):
    cfg, model, opt, state, mesh = _setup(arch, dims, axes, **kw)
    batch = _batch(cfg)
    s_sh, b_sh = _shardings(cfg, state, batch, mesh)
    new, met = steps.make_sharded_train_step(model, opt, s_sh, b_sh)(state, batch)
    want, want_m = _unsharded(model, opt, state, batch, mesh)
    ok, r, rm = _within(shd.gather(new), want, met, want_m)
    assert ok, (r, rm)
    _assert_layout(new, state, s_sh)
    assert all(met[k].device == mesh.devices.flat[0] for k in met)


@pytest.mark.parametrize("dims", [(4, 1), (2, 3)], ids=["4x1", "2x3"])
@pytest.mark.parametrize("arch,kw,apart", [("qwen3-8b", {}, True),
                                           ("kimi-k2-1t-a32b", {"remat": True}, False)],
                         ids=["qwen3", "kimi_remat"])
def test_a_loss_that_does_not_split_runs_the_batch_as_one_shard(monkeypatch, arch, kw, apart,
                                                                dims):
    """Off its expert-parallel branch (no model axis on (4, 1); 4 experts
    over 3 model shards on (2, 3)) the MoE routes the whole batch's tokens
    together (ranks, capacity, aux), as the reference's ``jit`` runs
    ``_moe_math_local``: the step runs the batch as one shard under the
    whole mesh, and a dense model still splits. Split anyway (a planted
    fault), the MoE fails the tolerance."""
    cfg, model, opt, state, mesh = _setup(arch, dims, ("data", "model"), **kw)
    batch = _batch(cfg)
    meshes, real = [], steps._forward_backward
    monkeypatch.setattr(steps, "_forward_backward",
                        lambda *a, **k: meshes.append(a[4]) or real(*a, **k))
    with obs.enabled() as tracer:
        new, met = _sharded(model, opt, state, batch, mesh, cfg)
    want, want_m = _unsharded(model, opt, state, batch, mesh)
    ok, r, rm = _within(shd.gather(new), want, met, want_m)
    assert ok, (r, rm)
    assert not [e for e in tracer.events if e.name == "moe_shard_map"]
    assert len(meshes) == (dims[0] if apart else 1) and (apart or meshes[0] is mesh)
    if not apart:
        monkeypatch.setattr(model, "shards_apart", lambda b: True)
        new, met = _sharded(model, opt, state, batch, mesh, cfg)
        ok, r, rm = _within(shd.gather(new), want, met, want_m)
        assert not ok and rm["aux"] > 100 * METRIC_RTOL, (r, rm)


@pytest.mark.parametrize("arch,kw,quant", [("qwen3-8b", {}, False),
                                           ("kimi-k2-1t-a32b", {"remat": True}, False),
                                           ("qwen3-8b", {}, True)],
                         ids=["qwen3", "kimi_remat", "qwen3_quant"])
def test_a_dropped_shard_gradient_fails_the_tolerance(monkeypatch, arch, kw, quant):
    cfg, model, opt, state, mesh = _setup(arch, (2, 4), ("data", "model"),
                                          adamw(1e-3, quantize=quant), **kw)
    batch = _batch(cfg)
    want, want_m = _unsharded(model, opt, state, batch, mesh)
    new, met = _sharded(model, opt, state, batch, mesh, cfg)
    ok, r, rm = _within(shd.gather(new), want, met, want_m, bf16_m=quant)
    assert ok, (r, rm)
    drop = _DropShard(monkeypatch)
    new, met = _sharded(model, opt, state, batch, mesh, cfg)
    assert drop.calls == 2
    ok, r, rm = _within(shd.gather(new), want, met, want_m, bf16_m=quant)
    assert not ok and rm["grad_norm"] > 100 * METRIC_RTOL, (r, rm)


def test_the_moe_takes_the_branch_in_the_forward_and_in_remats_recompute():
    """Every ``moe_shard_map`` span of the step (the forward and remat's
    recompute in the backward) reports dp 1, the shard's own tokens and
    the reference's per-shard capacity."""
    cfg, model, opt, state, mesh = _setup("kimi-k2-1t-a32b", (2, 2, 2),
                                          ("pod", "data", "model"), remat=True)
    batch = _batch(cfg, B=4, S=16)
    dp, mp = 4, 2
    T_loc = 4 * 16 // dp
    E, K = cfg.n_experts, cfg.experts_per_token
    C = max(1, int(T_loc * K / E * 1.25))
    with obs.enabled() as tracer:
        _sharded(model, opt, state, batch, mesh, cfg)
    spans = [e.args for e in tracer.events if e.name == "moe_shard_map"]
    assert len(spans) == dp * cfg.n_layers * 2  # each shard: forward + recompute a layer
    assert all((s["dp"], s["mp"], s["tokens"], s["capacity"], s["plain"])
               == (1, mp, T_loc, C, False) for s in spans), spans
    # without remat the backward does not recompute
    cfg2, model2, opt2, state2, _ = _setup("kimi-k2-1t-a32b", (2, 2, 2),
                                           ("pod", "data", "model"))
    with obs.enabled() as tracer:
        _sharded(model2, opt2, state2, batch, mesh, cfg2)
    assert len([e for e in tracer.events if e.name == "moe_shard_map"]) == dp * cfg.n_layers


# ---------------------------------------------------------------- the reference


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


@pytest.mark.parametrize("name,arch,kw,quant", REF_CASES, ids=[c[0] for c in REF_CASES])
def test_equals_the_references_sharded_step(ref_dir, name, arch, kw, quant):
    z = np.load(ref_dir / f"{name}.npz")
    params = convert.params_from_numpy(_nest({k[2:]: z[k] for k in z.files if k[:2] == "p/"}),
                                       "cpu")
    cfg, model, opt, state, mesh = _setup(arch, (2, 4), ("data", "model"),
                                          adamw(1e-3, quantize=quant), params=params, **kw)
    batch = {"tokens": torch.as_tensor(z["tokens"])}
    with obs.enabled() as tracer:
        new, met = _sharded(model, opt, state, batch, mesh, cfg)
    got = tree_leaves(shd.gather(new))
    ref = [z[f"s/{i:04d}"] for i in range(sum(k[:2] == "s/" for k in z.files))]
    assert len(got) == len(ref)
    structure = tree_flatten(steps.train_state_shapes(model, opt))[1]
    want = tree_unflatten(structure, [torch.from_numpy(r).to(g.dtype) for r, g in zip(ref, got)])
    want_m = {k[2:]: torch.as_tensor(z[k]) for k in z.files if k[:2] == "m/"}
    ok, r, rm = _within(shd.gather(new), want, met, want_m, bf16_m=quant)
    assert ok, (r, rm)
    spans = [e.args for e in tracer.events if e.name == "moe_shard_map"]
    if cfg.n_experts:
        assert spans and all(s["dp"] == 1 and s["tokens"] == 32 for s in spans)


# ---------------------------------------------------------------- the loss


def test_an_uneven_mask_weights_each_shard_by_its_count(monkeypatch):
    """Data shards 0 and 1 keep 2 of 15 targets a row, 2 and 3 all 15: the
    step's ce is the batch's masked token mean. The mean of the shards'
    means (a planted fault) fails."""
    cfg, model, opt, state, mesh = _setup("qwen3-8b", (4, 2), ("data", "model"))
    mask = np.ones((4, 16), np.int32)
    mask[:2, 2:] = 0
    batch = _batch(cfg, mask=mask)
    want, want_m = _unsharded(model, opt, state, batch, mesh)
    new, met = _sharded(model, opt, state, batch, mesh, cfg)
    ok, r, rm = _within(shd.gather(new), want, met, want_m)
    assert ok, (r, rm)
    monkeypatch.setattr(steps, "_loss_weights",
                        lambda counts, dev0: [torch.full((), 1 / len(counts)) for _ in counts])
    new, met = _sharded(model, opt, state, batch, mesh, cfg)
    ok, r, rm = _within(shd.gather(new), want, met, want_m)
    assert not ok and rm["ce"] > 100 * METRIC_RTOL, (r, rm)


def test_a_batch_that_does_not_divide_runs_as_one_shard():
    """B 3 over 2 data shards: ``batch_spec`` leaves it replicated and the
    step runs it whole under the whole mesh, as the reference's jit runs
    a replicated batch; the MoE still splits its tokens there."""
    for arch, kw in (("qwen3-8b", {}), ("kimi-k2-1t-a32b", {"remat": True})):
        cfg, model, opt, state, mesh = _setup(arch, (2, 4), ("data", "model"), **kw)
        batch = _batch(cfg, B=3)
        assert shd.batch_spec(batch, mesh)["tokens"] == shd.P(None, None)
        with obs.enabled() as tracer:
            new, met = _sharded(model, opt, state, batch, mesh, cfg)
        want, want_m = _unsharded(model, opt, state, batch, mesh)
        ok, r, rm = _within(shd.gather(new), want, met, want_m)
        assert ok, (arch, r, rm)
        spans = [e.args for e in tracer.events if e.name == "moe_shard_map"]
        assert all(s["dp"] == 2 for s in spans) and len(spans) == 2 * cfg.n_layers * bool(
            cfg.n_experts)


# ---------------------------------------------------------------- the optimizer


def test_quantized_moments_whose_pieces_cut_across_blocks():
    """qwen3's (2, 256, 256) and (2, 256, 512) leaves cut into pieces of 64
    or 128 columns: each v_q piece cuts across the flattened leaf's blocks
    of 256, so those leaves update whole and are cut again."""
    cfg, model, opt, state, mesh = _setup("qwen3-8b", (2, 4), ("data", "model"),
                                          adamw(1e-3, quantize=True))
    batch = _batch(cfg)
    s_sh, b_sh = _shardings(cfg, state, batch, mesh)
    new, met = steps.make_sharded_train_step(model, opt, s_sh, b_sh)(state, batch)
    # rows of 256 or 512 values are whole blocks; a piece holds part of each
    cut = [leaf for leaf in tree_leaves(new["opt"]["v_q"])
           if leaf.shape[-1] % 256 == 0 and leaf.pieces.flat[0].shape[-1] < leaf.shape[-1]]
    assert len(cut) >= 6
    want, want_m = _unsharded(model, opt, state, batch, mesh)
    ok, r, rm = _within(shd.gather(new), want, met, want_m, bf16_m=True)
    assert ok, (r, rm)
    _assert_layout(new, state, s_sh)


@pytest.mark.parametrize("opt", [sgd(1e-2), momentum(1e-2, quantize=True)],
                         ids=["sgd", "momentum_bf16"])
def test_element_wise_optimizers_update_piece_by_piece(opt):
    cfg, model, opt, state, mesh = _setup("qwen3-8b", (2, 4), ("data", "model"), opt)
    batch = _batch(cfg)
    new, met = _sharded(model, opt, state, batch, mesh, cfg)
    want, want_m = _unsharded(model, opt, state, batch, mesh)
    ok, r, rm = _within(shd.gather(new), want, met, want_m, bf16_m=True)
    assert ok, (r, rm)


def test_three_steps_feed_the_placed_state_back():
    cfg, model, opt, state, mesh = _setup("kimi-k2-1t-a32b", (2, 4), ("data", "model"),
                                          remat=True)
    s_sh, b_sh = _shardings(cfg, state, _batch(cfg), mesh)
    step = steps.make_sharded_train_step(model, opt, s_sh, b_sh)
    ref = steps.make_train_step(model, opt)
    placed, want = state, state
    for i in range(3):
        batch = _batch(cfg, seed=i)
        placed, met = step(placed, batch)
        with use_mesh(mesh):
            want, want_m = ref(want, batch)
        ok, r, rm = _within(shd.gather(placed), want, met, want_m)
        assert ok, (i, r, rm)
        _assert_layout(placed, state, s_sh)
    assert int(shd.gather(placed["step"])) == 3


# ---------------------------------------------------------------- families


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "kimi-k2-1t-a32b", "arctic-480b",
                                  "qwen2-vl-2b", "falcon-mamba-7b", "zamba2-2.7b",
                                  "whisper-tiny"],
                         ids=["dense", "moe", "moe_dense_residual", "vlm", "ssm", "hybrid",
                              "audio"])
def test_every_family_matches_its_unsharded_step(arch):
    """One reduced config a family on (2, 2). Arctic's dense residual
    (``moe.dense_mlp``, its 2 layers split over the model axis) is read
    whole as a plain MLP, not as an expert stack."""
    cfg, model, opt, state, mesh = _setup(arch, (2, 2), ("data", "model"), attn_chunk=8)
    batch = _batch(cfg, B=4, S=12)
    s_sh, b_sh = _shardings(cfg, state, batch, mesh)
    new, met = steps.make_sharded_train_step(model, opt, s_sh, b_sh)(state, batch)
    want, want_m = _unsharded(model, opt, state, batch, mesh)
    ok, r, rm = _within(shd.gather(new), want, met, want_m)
    assert ok, (r, rm)
    _assert_layout(new, state, s_sh)


# ---------------------------------------------------------------- inputs


def test_placed_and_plain_inputs_give_the_same_step():
    """A tensor leaf is placed by its sharding first, as ``jit`` reshards
    its inputs; a ``Placed`` leaf with another sharding is re-placed."""
    cfg, model, opt, state, mesh = _setup("qwen3-8b", (2, 4), ("data", "model"))
    batch = _batch(cfg)
    s_sh, b_sh = _shardings(cfg, state, batch, mesh)
    step = steps.make_sharded_train_step(model, opt, s_sh, b_sh)
    a, ma = step(state, batch)
    other = shd._map_specs(lambda s: shd.NamedSharding(mesh, shd.P()), s_sh)
    b, mb = step(shd.place({k: state[k] for k in ("params", "opt", "step")}, other),
                 shd.place(batch, b_sh))
    for x, y in zip(tree_leaves(shd.gather(a)), tree_leaves(shd.gather(b))):
        assert _bits_equal(x, y)
    assert all(_bits_equal(ma[k], mb[k]) for k in ma)


def test_a_spec_that_does_not_divide_raises():
    cfg, model, opt, state, mesh = _setup("qwen3-8b", (2, 4), ("data", "model"))
    batch = _batch(cfg)
    s_sh, b_sh = _shardings(cfg, state, batch, mesh)
    s_sh["params"]["final_norm"] = shd.NamedSharding(mesh, shd.P(("data", "model")))
    with pytest.raises(ValueError, match="does not divide"):
        steps.make_sharded_train_step(model, opt, s_sh, b_sh)(
            dict(state, params=dict(state["params"], final_norm=torch.ones(12))), batch)
    other = _mesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="different meshes"):
        steps.make_sharded_train_step(model, opt, s_sh, shd.to_named(
            shd.batch_spec(batch, other), other))


def test_shard_grid_and_row_meshes_follow_the_moe_branch():
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    mesh.devices[:] = np.arange(8).reshape(2, 2, 2).astype(object)  # labels for the check
    grid, dp_axes = steps._shard_grid(mesh)
    assert dp_axes == ("pod", "data") and grid.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    info = {"dp_axes": dp_axes, "dp": 4, "mp": 2}
    assert tL._shard_devices(mesh, info).tolist() == grid.tolist()
    for i in range(4):
        row = steps._row_mesh(mesh, dp_axes, i)
        assert row.devices.shape == (1, 1, 2) and row.devices.ravel().tolist() == list(grid[i])
