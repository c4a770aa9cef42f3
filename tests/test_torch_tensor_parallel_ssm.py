"""The tensor-parallel route of the sharded train, prefill and decode steps
(``launch.steps``, ``tensor_parallel=True``) for the ssm (falcon-mamba,
Mamba-1), hybrid (zamba2, Mamba-2 and a shared attention block) and audio
(whisper) families on the CPU: meshes of repeated ``"cpu"`` devices, one
process driving every shard, as ``tests/test_torch_tensor_parallel.py``
and ``tests/test_torch_tensor_parallel_serve.py`` run the transformer
families.

Model shard m runs a Mamba-1 block's d_inner / M channels, a Mamba-2
block's H / M heads, an attention's H / M heads (whisper's cross-attention
too) and an MLP's d_ff / M columns; the embedding and the head are
vocab-parallel where the vocab divides. Small configs (f32): ssm d 64, d_inner
128, 2 layers; hybrid d 64, 8 SSD heads of 16, state 16, 2 segments of 2
Mamba-2 layers, 4 attention heads; whisper d 64, 4 heads, 2 + 2 layers,
encoder_seq 32.

What they must equal:

- on a (1, 1) mesh, the unsharded steps bit for bit; on a mesh without a
  model axis ((2, 1)), the gather route bit for bit;
- on (2, 2), (1, 4) and (2, 2, 2), the unsharded steps under ``use_mesh``
  of the same mesh, within the bounds below;
- the reference's jitted sharded prefill and donating decode on a (2, 4)
  mesh of 8 host devices (ssm and hybrid), within the same bounds.

Bounds, each ``max |a - b| / max |b|`` (f32), beside the readings over
every case here and the planted faults' (model shard 1's partial dropped
from one reduction: ``x_proj``'s partials, ``out_proj``'s row sum, the
gated norm's sum of squares, the cross-attention's row sum):

- train step: the metrics (loss, ce, grad norm) ``METRIC_RTOL`` 1e-6,
  readings up to 1.8e-7 (faults 3.9e-3 to 6.9e-2); each leaf's gradient
  (the step's summed gradients before the clip) ``GRAD_RTOL`` 1e-5,
  readings up to 2.1e-6 (faults 0.92 to 1.35); the params after one SGD
  step ``PARAM_RTOL`` 1e-5, readings up to 1.4e-6 (faults 1.1e-2 to 1.2);
- prefill and 4 decode steps: logits ``LOGIT_RTOL`` 1e-5 and every
  cache leaf ``CACHE_RTOL`` 1e-5 (``tests/test_torch_tensor_parallel_serve``'s),
  readings up to 1.2e-6 (against the reference's steps: 1.0e-6 logits,
  1.2e-6 cache, where the port's unsharded steps read 1.2e-6), ``pos`` bit
  for bit; the faults read logits 6.6e-2 to 1.2 and caches 0.36 to 0.89
  apart.
"""

import math
import sys

import numpy as np
import pytest
import torch

from _multidevice import run_multidevice
from repro_torch import convert
from repro_torch.core.tree import tree_flatten, tree_leaves
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import layers as tL
from repro_torch.optim import sgd
from repro_torch.util import use_mesh
from test_torch_sharded_train import METRIC_RTOL, _batch, _bits_equal, _mesh, _nest, _setup
from test_torch_tensor_parallel import _split, _step
from test_torch_tensor_parallel_serve import (B, CACHE_RTOL, GEN, LOGIT_RTOL,
                                              _assert_cut_by_cache_spec, _inputs, _model, _rel,
                                              _sharded, _unsharded)

GRAD_RTOL = 1e-5
PARAM_RTOL = 1e-5
LR = 0.1

FAMILIES = {
    "ssm": ("falcon-mamba-7b", {"d_model": 64}),
    "hybrid": ("zamba2-2.7b", {"d_model": 64, "n_layers": 4, "attn_every": 2, "ssm_heads": 8,
                               "ssm_state": 16, "d_ff": 128}),
    "audio": ("whisper-tiny", {"d_model": 64, "d_ff": 128, "attn_chunk": 8}),
}
TP_MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
             ((2, 2, 2), ("pod", "data", "model"))]
TP_IDS = ["2x2", "1x4", "2x2x2"]
# each family's tensor-parallel blocks: the span kinds of a prefill (and of
# the train step's forward) and of a decode step
# (and the kind that runs once a layer a data shard in each)
KINDS = {"ssm": ({"mamba1"}, {"mamba1_decode"}),
         "hybrid": ({"mamba2", "attn", "mlp"}, {"mamba2_decode", "attn_decode", "mlp"}),
         "audio": ({"attn", "cross_attn", "mlp"}, {"attn_decode", "cross_attn", "mlp"})}
PER_LAYER = {"ssm": ("mamba1", "mamba1_decode"), "hybrid": ("mamba2", "mamba2_decode"),
             "audio": ("cross_attn", "cross_attn")}
# the new reductions: (family, the function whose ``layers._row_sum`` drops
# a partial)
FAULTS = [("ssm", "_x_proj_split"), ("ssm", "_out_proj_split"), ("hybrid", "_gate_norm_split"),
          ("audio", "_cross_attend_split")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (as ``tests/test_torch_sharded_train.py``: the
    steps' many small ops otherwise wait on the thread pool's barriers
    beside the suite's other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- helpers


class _DropAt:
    """Planted fault: model shard ``k``'s partial left out of the
    ``layers._row_sum`` calls made by the function named ``caller``."""

    def __init__(self, monkeypatch, caller: str, k: int = 1):
        self.calls, real = 0, tL._row_sum

        def row_sum(partials, home, dtype):
            if sys._getframe(1).f_code.co_name != caller:
                return real(partials, home, dtype)
            self.calls += 1
            return real([p for m, p in enumerate(partials) if m != k], home, dtype)

        monkeypatch.setattr(tL, "_row_sum", row_sum)


def _grads_of_step(monkeypatch):
    """Records the sharded step's summed gradients (each leaf's pieces,
    before the clip): a spy on ``steps._clip``."""
    seen, real = [], steps._clip

    def clip(grads, clip_norm, dev0):
        seen.append([shd.assemble(list(g.items()), _whole_box(g), "cpu", next(iter(g.values())).dtype)
                     for g in grads])
        return real(grads, clip_norm, dev0)

    monkeypatch.setattr(steps, "_clip", clip)
    return seen


def _whole_box(pieces):
    """The box that a leaf's distinct pieces cover together."""
    boxes = list(pieces)
    return tuple((min(b[d][0] for b in boxes), max(b[d][1] for b in boxes))
                 for d in range(len(boxes[0])))


def _train(family, dims, axes, monkeypatch, tp=True):
    """One sharded SGD step and the unsharded step under the same mesh:
    (metrics readings, worst gradient reading, params reading, spans)."""
    arch, kw = FAMILIES[family]
    cfg, model, opt, state, mesh = _setup(arch, dims, axes, sgd(LR), **kw)
    batch = _batch(cfg, B=4, S=12)
    with monkeypatch.context() as mp:
        seen = _grads_of_step(mp)
        new, met, spans = _step(model, opt, state, batch, mesh, cfg, tp=tp)
    with use_mesh(mesh):
        _, _, want_g, _ = steps._value_and_grad(model, state["params"], batch)
        want, want_m = steps.make_train_step(model, opt)(state, batch)
    rm = {k: abs(float(met[k]) - float(want_m[k])) / max(abs(float(want_m[k])), 1e-30)
          for k in want_m}
    rg = max(_rel(a, b) for a, b in zip(seen[0], tree_leaves(want_g)))
    rp = max(_rel(a, b) for a, b in zip(tree_leaves(shd.gather(new["params"])),
                                        tree_leaves(want["params"])))
    return rm, rg, rp, spans, (cfg, state, mesh, batch)


def _serve(family, dims, monkeypatch=None, fault=None, **kw):
    """The sharded prefill and decode steps against the unsharded ones:
    (worst logit reading, {leaf: reading}, got, cache, spans, cfg)."""
    arch, base = FAMILIES[family]
    cfg, model, params = _model(arch, **dict(base, **kw))
    batch, toks = _inputs(cfg)
    mesh = _mesh(dims, ("data", "model") if len(dims) == 2 else ("pod", "data", "model"))
    want, wcache = _unsharded(model, params, batch, toks, mesh)
    if fault is None:
        got, cache, spans = _sharded(model, params, batch, toks, mesh)
    else:
        with monkeypatch.context() as mp:
            _DropAt(mp, fault)
            got, cache, spans = _sharded(model, params, batch, toks, mesh)
    lg = max(_rel(a, b) for a, b in zip(got, want))
    return lg, {n: _rel(shd.gather(cache[n]), wcache[n]) for n in wcache}, got, cache, spans, cfg


# ---------------------------------------------------------------- the train step


@pytest.mark.parametrize("dims,axes", TP_MESHES, ids=TP_IDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_the_unsharded_step(family, dims, axes, monkeypatch):
    """Loss, gradients and the params after one step within the bounds;
    each block kind of the family takes its tensor-parallel branch once a
    layer a data shard; every Mamba leaf (and every attention, MLP and
    vocab leaf) is a block leaf, each model shard holding 1 / M of it."""
    rm, rg, rp, spans, (cfg, state, mesh, batch) = _train(family, dims, axes, monkeypatch)
    assert max(rm.values()) <= METRIC_RTOL and rg <= GRAD_RTOL and rp <= PARAM_RTOL, (rm, rg, rp)
    assert {s["kind"] for s in spans} == KINDS[family][0]
    dp, mp = math.prod(dims[:-1]), dims[-1]
    assert all(s["mp"] == mp for s in spans)
    live, lives = steps._shard_live(steps._placed(state["params"], shd.to_named(
        shd.tree_param_specs(state["params"], mesh, n_kv_heads=cfg.n_kv_heads), mesh)), mesh, cfg)
    split = _split(live)
    mamba = {p.split("/")[-1] for p in split if "/mamba/" in p}
    if family == "ssm":
        assert mamba == {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log",
                         "D", "out_proj"}
    if family == "hybrid":
        assert mamba == {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "gate_norm",
                         "out_proj"}
        assert {"shared/attn/wq", "shared/mlp/w_up", "embed", "lm_head"} <= set(split)
        assert "shared/in_proj" not in split
    if family == "audio":
        assert {"dec_layers/cross_attn/wq", "dec_layers/self_attn/wo", "enc_layers/mlp/w_down",
                "embed"} <= set(split) and "frame_proj" not in split
    leaves = dict(zip(["/".join(p) for p in steps._leaf_paths(state["params"])],
                      tree_leaves(state["params"])))
    for path, blk in split.items():
        assert len(blk.blocks) == mp
        assert all(b.numel() * mp == leaves[path].numel() for b in blk.blocks), path


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_by_one_and_without_a_model_axis_are_bit_for_bit(family, monkeypatch):
    """On (1, 1) the route is the unsharded step bit for bit; on (2, 1) it
    is the gather route bit for bit (no block leaves)."""
    arch, kw = FAMILIES[family]
    cfg, model, opt, state, mesh = _setup(arch, (1, 1), ("data", "model"), sgd(LR), **kw)
    batch = _batch(cfg, B=4, S=12)
    new, met, spans = _step(model, opt, state, batch, mesh, cfg)
    want, want_m = steps.make_train_step(model, opt)(state, batch)
    assert not spans
    assert all(_bits_equal(a, b) for a, b in zip(tree_leaves(shd.gather(new)), tree_leaves(want)))
    assert all(_bits_equal(met[k], want_m[k]) for k in want_m)
    mesh = _mesh((2, 1), ("data", "model"))
    new, met, spans = _step(model, opt, state, batch, mesh, cfg)
    gather, gather_m, _ = _step(model, opt, state, batch, mesh, cfg, tp=False)
    assert not spans
    assert all(_bits_equal(a, b) for a, b in zip(tree_leaves(shd.gather(new)),
                                                 tree_leaves(shd.gather(gather))))
    assert all(_bits_equal(met[k], gather_m[k]) for k in gather_m)


# ---------------------------------------------------------------- prefill and decode


@pytest.mark.parametrize("dims", [d for d, _ in TP_MESHES], ids=TP_IDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_serve_matches_the_unsharded_steps(family, dims):
    """The prefill and 4 decode steps within the bounds; each block kind
    takes its branch once a layer a data shard; the cache is cut by
    ``cache_spec``. A unit whose box is its own piece writes it in place:
    the ssm states always, the hybrid's conv state where the data axis
    has size 1; the hybrid's head-split ``ssm_h`` (pieces cut on P) is
    read into a copy and written back."""
    lg, cr, got, cache, spans, cfg = _serve(family, dims)
    assert lg <= LOGIT_RTOL and all(v <= CACHE_RTOL for v in cr.values()), (lg, cr)
    if "pos" in cr:
        assert cr["pos"] == 0.0
    _assert_cut_by_cache_spec(cache, cache["h" if family == "ssm" else "k"].sharding.mesh)
    dp, mp = math.prod(dims[:-1]), dims[-1]
    pre = [s["kind"] for s in spans[("prefill", "tensor_parallel")]]
    dec = [s["kind"] for s in spans[("decode", "tensor_parallel")]]
    assert set(pre) == KINDS[family][0] and set(dec) == KINDS[family][1]
    assert pre.count(PER_LAYER[family][0]) == dp * cfg.n_layers
    assert dec.count(PER_LAYER[family][1]) == GEN * dp * cfg.n_layers
    assert all(s["mp"] == mp for s in spans[("decode", "tensor_parallel")])
    copies = {c["leaf"] for c in spans.get(("decode", "cache_copy"), [])}
    if family == "ssm":
        assert not copies
    if family == "hybrid":
        assert "ssm_h" in copies and not copies & {"k", "v", "pos"}
        assert dp > 1 or "ssm_conv" not in copies
    assert got[0].shape == (B, cfg.vocab_size)


def test_state_pieces_are_written_in_place():
    """falcon-mamba on (2, 2): every decode step writes the units' pieces
    of ``h`` and ``conv`` in place (the same tensors, the same storage)."""
    arch, kw = FAMILIES["ssm"]
    cfg, model, params = _model(arch, **kw)
    batch, toks = _inputs(cfg)
    mesh = _mesh((2, 2), ("data", "model"))
    ptrs, steps_seen = {}, []

    def same(cache):
        now = {(n, i): (p, p.data_ptr()) for n in cache for i, p in enumerate(cache[n].pieces.flat)}
        if ptrs:
            assert all(now[k][0] is ptrs[k][0] and now[k][1] == ptrs[k][1] for k in now)
            assert any(not _bits_equal(now[k][0], before[k]) for k in now)
        ptrs.update(now)
        before.clear()
        before.update({k: v[0].clone() for k, v in now.items()})
        steps_seen.append(1)

    before = {}
    _, _, spans = _sharded(model, params, batch, toks, mesh, each_step=same)
    assert len(steps_seen) == GEN and len(ptrs) == 2 * 4
    assert ("decode", "cache_copy") not in spans


def test_whisper_attention_reads_whole_where_its_heads_do_not_divide(monkeypatch):
    """6 heads on (1, 4): every attention reads whole on the first device
    (the head rule), the MLPs and the vocab split; the self-attention cache
    is the first device's alone. Train step and serve within the bounds."""
    heads = {"n_heads": 6, "n_kv_heads": 6, "d_model": 96}
    lg, cr, _, cache, spans, cfg = _serve("audio", (1, 4), **heads)
    assert lg <= LOGIT_RTOL and all(v <= CACHE_RTOL for v in cr.values()), (lg, cr)
    assert {s["kind"] for s in spans[("prefill", "tensor_parallel")]} == {"mlp"}
    assert {s["kind"] for s in spans[("decode", "tensor_parallel")]} == {"mlp"}
    arch, kw = FAMILIES["audio"]
    cfg, model, opt, state, mesh = _setup(arch, (1, 4), ("data", "model"), sgd(LR),
                                          **dict(kw, **heads))
    live, _ = steps._shard_live(state["params"], mesh, cfg)
    split = _split(live)
    assert not [p for p in split if "attn" in p]
    assert {"enc_layers/mlp/w_up", "dec_layers/mlp/w_down", "embed", "lm_head"} <= set(split)
    assert steps._split_cache(live) == {}


# ---------------------------------------------------------------- planted faults


@pytest.mark.parametrize("family,caller", FAULTS, ids=[c for _, c in FAULTS])
def test_a_dropped_partial_of_each_new_reduction_fails_the_bounds(family, caller, monkeypatch):
    """Model shard 1's partial left out of one reduction's sums: the train
    step's gradients and the prefill and decode logits fail their bounds
    by far."""
    with monkeypatch.context() as mp:
        drop = _DropAt(mp, caller)
        _, rg, _, _, _ = _train(family, (2, 2), ("data", "model"), monkeypatch)
        assert drop.calls > 0
    assert rg > 1000 * GRAD_RTOL, rg
    lg, cr, *_ = _serve(family, (2, 2), monkeypatch, fault=caller)
    assert lg > 1000 * LOGIT_RTOL, lg


def test_a_mamba_block_split_in_part_raises():
    """No fallback: a Mamba block whose leaves are split in part, or split
    over shards that its heads do not divide, raises."""
    from repro_torch.models import ssm as tS

    arch, kw = FAMILIES["hybrid"]
    cfg, model, params = _model(arch, **kw)
    mesh = _mesh((1, 4), ("data", "model"))
    live, _ = steps._shard_live(params, mesh, cfg, grad=False)
    seg = steps._Blocks.unbind(live["segments"]["mamba"]["in_proj"])[0]
    assert isinstance(seg, steps._Blocks) and seg.lead == 1
    p = {k: v.unbind()[0].unbind()[0] for k, v in live["segments"]["mamba"].items()}
    x = torch.zeros(2, 3, cfg.d_model)
    out, _ = tS.mamba2_block(p, x, cfg)
    assert out.shape == x.shape
    whole = dict(p, out_proj=torch.cat(p["out_proj"].blocks, dim=0))
    with pytest.raises(ValueError, match="Mamba block"):
        tS.mamba2_block(whole, x, cfg)
    with pytest.raises(ValueError, match="do not divide"):
        tS.mamba2_block(p, x, cfg.with_(ssm_heads=2))
    assert tS.split_axis(cfg, "gate_norm", 3) is None and tS.split_axis(cfg, "x_proj", 4) is None
    assert tS.split_axis(_model("falcon-mamba-7b", d_model=64)[0], "x_proj", 4) == -2


# ---------------------------------------------------------------- the reference

_REF_CHILD = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_arch
from repro.models import build_model
from repro.launch.steps import make_prefill_step, make_decode_step
from repro.launch import sharding as shd
from repro.launch.mesh import make_mesh
from repro.util import use_mesh

def key(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)

sds = lambda t: jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), t)
mesh = make_mesh((2, 4), ("data", "model"))
for name, arch, kw in CASES:
    cfg = get_arch(arch).reduced().with_(**kw)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    toks = rng.randint(0, cfg.vocab_size, (B, GEN)).astype(np.int32)
    p_sh = shd.to_named(shd.tree_param_specs(sds(params), mesh, n_kv_heads=cfg.n_kv_heads), mesh)
    batch = {"tokens": jnp.asarray(tokens)}
    out = {"tokens": tokens, "toks": toks}
    with use_mesh(mesh):
        b_sh = shd.to_named(shd.batch_spec(sds(batch), mesh), mesh)
        prefill = jax.jit(make_prefill_step(model), in_shardings=(p_sh, b_sh))
        logits, cache = prefill(jax.device_put(params, p_sh), jax.device_put(batch, b_sh))
        out["l/0"] = np.asarray(logits)
        cache = model.grow_cache(cache, S + GEN)
        c_sh = shd.to_named(shd.cache_spec(sds(cache), mesh), mesh)
        for g in range(GEN):
            step = {"tokens": jnp.asarray(toks[:, g:g + 1]),
                    "pos": jnp.full((B,), S + g, jnp.int32)}
            s_sh = shd.to_named(shd.batch_spec(sds(step), mesh), mesh)
            decode = jax.jit(make_decode_step(model), in_shardings=(p_sh, c_sh, s_sh),
                             donate_argnums=(1,))
            logits, cache = decode(jax.device_put(params, p_sh), jax.device_put(cache, c_sh),
                                   jax.device_put(step, s_sh))
            out[f"l/{g + 1}"] = np.asarray(logits)
    out.update({"c/" + k: np.asarray(v) for k, v in cache.items()})
    out.update({"p/" + key(path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(params)[0]})
    np.savez(OUT + "/" + name + ".npz", **out)
    print(name, "ok")
"""


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("tensor_parallel_ssm")
    cases = [(f, *FAMILIES[f]) for f in ("ssm", "hybrid")]
    run_multidevice(f"B, S, GEN = {B}, 16, {GEN}\nCASES = {cases!r}\nOUT = {str(out)!r}\n"
                    + _REF_CHILD)
    return out


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_equals_the_references_sharded_prefill_and_decode(family, ref_dir):
    """The reference's jitted prefill and (donating) decode under
    in_shardings on a (2, 4) mesh of 8 host devices against the port's
    tensor-parallel steps on the same numpy params and tokens: each step's
    logits and every cache leaf within the bounds."""
    z = np.load(ref_dir / f"{family}.npz")
    params = convert.params_from_numpy(_nest({k[2:]: z[k] for k in z.files if k[:2] == "p/"}),
                                       "cpu")
    arch, kw = FAMILIES[family]
    cfg, model, _ = _model(arch, **kw)
    assert tree_flatten(params)[1] == tree_flatten(model.init(None, "meta"))[1]
    mesh = _mesh((2, 4), ("data", "model"))
    got, cache, spans = _sharded(model, params, {"tokens": torch.as_tensor(z["tokens"])},
                                 z["toks"], mesh)
    lg = max(_rel(a, torch.as_tensor(z[f"l/{g}"])) for g, a in enumerate(got))
    cr = {n: _rel(shd.gather(cache[n]), torch.as_tensor(z["c/" + n])) for n in cache}
    assert lg <= LOGIT_RTOL and all(v <= CACHE_RTOL for v in cr.values()), (lg, cr)
    assert {s["kind"] for s in spans[("decode", "tensor_parallel")]} == KINDS[family][1]
