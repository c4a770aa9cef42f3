"""The donating train step (``make_train_step(..., donate=True)``,
``make_sharded_train_step(..., donate=True)``) on the CPU, the port's
counterpart of the reference's ``jax.jit(make_train_step(model, opt),
donate_argnums=(0,))``.

What it must do:

- equal the step without ``donate`` bit for bit, on every leaf, piece and
  metric: unsharded; sharded on (1, 1), (2, 2), (1, 4) and (2, 1) by both
  routes; AdamW with f32 and quantized moments, ``sgd`` and ``momentum``;
  one reduced config a family;
- write every leaf (every piece of every ``Placed`` leaf) where it is:
  the returned state's tensors are the given ones, at the same
  ``data_ptr``, device and dtype; a leaf given as a tensor is placed
  first and stays untouched;
- refuse tensors that share storage, before anything is written;
- track the reference's donated jitted step over three steps within
  ``tests/test_torch_train.py``'s three-step bounds (the sharded-train
  ones hold one step: after three, the f32 moments read 1.0e-4 apart,
  the unsharded step's own distance, donating or not).

``DONATE_BOX_VALUES`` is cut to 1,024 values here, so the reduced leaves
update in several boxes of rows, as the full-width ones do (a test holds
that some leaves take several boxes, the quantized ones too). A planted
fault (``step`` advanced before the last leaf, which changes that leaf's
rate and bias corrections) must fail the bit-for-bit check.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs.base import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.models.registry import build_model as jbuild
from repro_torch import convert
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models.registry import build_model
from repro_torch import optim as topt
from repro_torch.optim import adamw, momentum, sgd
from repro_torch.util import use_mesh
from test_torch_sharded_train import _batch, _bits_equal, _setup, _shardings
from test_torch_train import TINY, _np
from test_torch_train import _cfgs as _train_cfgs
from test_torch_train import _opts as _train_opts

BOX_VALUES = 1024

OPTS = {"adamw": lambda: adamw(1e-3), "adamw_quant": lambda: adamw(1e-3, quantize=True),
        "sgd": lambda: sgd(1e-2), "momentum": lambda: momentum(1e-2),
        "momentum_bf16": lambda: momentum(1e-2, quantize=True)}
MESHES = [(1, 1), (2, 2), (1, 4), (2, 1)]
FAMILIES = {"dense": "stablelm-1.6b", "moe": "kimi-k2-1t-a32b", "vlm": "qwen2-vl-2b",
            "ssm": "falcon-mamba-7b", "hybrid": "zamba2-2.7b", "audio": "whisper-tiny"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, as ``tests/test_torch_sharded_train.py``: the
    step's many small ops on tiny tensors otherwise wait on the thread
    pool's barriers beside the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _small_boxes(monkeypatch):
    monkeypatch.setattr(steps, "DONATE_BOX_VALUES", BOX_VALUES)


# ---------------------------------------------------------------- helpers


def _copy(tree):
    return tree_map(lambda t: t.clone(), tree)


def _pieces(state):
    """Every tensor of a state: a ``Placed`` leaf's pieces in the mesh's order."""
    out = []
    for leaf in tree_leaves({k: state[k] for k in ("params", "opt", "step")}):
        out += list(leaf.pieces.flat) if isinstance(leaf, shd.Placed) else [leaf]
    return out


def _layout(tensors):
    return [(t.data_ptr(), t.device, t.dtype, tuple(t.shape)) for t in tensors]


def _assert_bits(got, want, got_m, want_m):
    a, b = _pieces(got), _pieces(want)
    assert len(a) == len(b)
    unequal = [i for i, (x, y) in enumerate(zip(a, b)) if not _bits_equal(x, y)]
    assert not unequal, unequal
    assert list(got_m) == list(want_m)
    assert all(_bits_equal(got_m[k], want_m[k]) for k in want_m)


def _run_both(step, donating, state, batches, place=None):
    """``step`` from ``state`` and ``donating`` from a copy of it (placed
    by ``place``) over ``batches``: (state, metrics) of each, and whether
    every donated tensor stayed where it was (and the unsharded step
    returned the given state itself)."""
    want, given = _copy(state), _copy(state)
    if place is not None:
        want, given = place(want), place(given)
    layout = _layout(_pieces(given))
    stayed = True
    for b in batches:
        want, want_m = step(want, b)
        new, got_m = donating(given, b)
        stayed &= _layout(_pieces(new)) == layout and (place is not None or new is given)
        given = new
    return want, want_m, given, got_m, stayed


def _sharded_steps(model, opt, state, batch, mesh, cfg, tp):
    s_sh, b_sh = _shardings(cfg, state, batch, mesh)
    return (steps.make_sharded_train_step(model, opt, s_sh, b_sh, tensor_parallel=tp),
            steps.make_sharded_train_step(model, opt, s_sh, b_sh, tensor_parallel=tp,
                                          donate=True), s_sh)


# ---------------------------------------------------------------- the unsharded step


@pytest.mark.parametrize("name", list(OPTS))
def test_the_donated_step_is_the_step_bit_for_bit(name):
    cfg, model, opt, state, _ = _setup("qwen3-8b", (1, 1), ("data", "model"), OPTS[name]())
    batches = [_batch(cfg, seed=i) for i in range(3)]
    want, want_m, got, got_m, stayed = _run_both(
        steps.make_train_step(model, opt), steps.make_train_step(model, opt, donate=True),
        state, batches)
    _assert_bits(got, want, got_m, want_m)
    assert stayed and int(got["step"]) == 3


def test_leaves_update_in_several_boxes_of_rows():
    """At ``BOX_VALUES`` the reduced qwen3's stacked leaves take a box of
    rows at a time; a quantized moment's boxes hold whole blocks."""
    cfg, model, opt, state, _ = _setup("qwen3-8b", (1, 1), ("data", "model"))
    shapes = [tuple(p.shape) for p in tree_leaves(state["params"])]
    many = [s for s in shapes if len(steps._row_boxes(s, False)) > 1]
    blocks = [s for s in shapes if len(steps._row_boxes(s, True)) > 1]
    assert len(many) >= 6 and len(blocks) >= 6
    for s in shapes:
        boxes = steps._row_boxes(s, True)
        row = math.prod(s[1:])
        assert all((b[0][1] - b[0][0]) * row % 256 == 0 for b in boxes[:-1])
        assert [b[0] for b in boxes] == sorted(b[0] for b in boxes)
        n = math.prod(s)
        scale = [steps._state_box("v_scale", b, s)[0] for b in boxes]
        assert scale[0][0] == 0 and scale[-1][1] == -(-n // 256)
        assert all(a[1] == b[0] for a, b in zip(scale, scale[1:]))


def test_a_step_advanced_before_the_last_leaf_fails_bit_for_bit(monkeypatch):
    """Planted fault: ``step`` advanced before the last leaf's update (and
    not after it), so the last leaf reads step + 1's rate and bias
    corrections while ``step`` ends right. The bit-for-bit check must
    fail on that leaf alone."""
    cfg, model, opt, state, _ = _setup("qwen3-8b", (1, 1), ("data", "model"))
    batch = _batch(cfg)
    want, want_m = steps.make_train_step(model, opt)(_copy(state), batch)
    n, calls = len(tree_leaves(state["params"])), []
    real_leaf, real_advance = steps._update_leaf, steps._advance

    def leaf(opt_, step, *a):
        calls.append(1)
        if len(calls) == n:
            real_advance(step)
        return real_leaf(opt_, step, *a)

    monkeypatch.setattr(steps, "_update_leaf", leaf)
    monkeypatch.setattr(steps, "_advance", lambda step: None)
    got, got_m = steps.make_train_step(model, opt, donate=True)(_copy(state), batch)
    assert int(got["step"]) == 1 and len(calls) == n
    groups = {"params": tree_leaves(got["params"]), "m": tree_leaves(got["opt"]["m"]),
              "v": tree_leaves(got["opt"]["v"])}
    wants = {"params": tree_leaves(want["params"]), "m": tree_leaves(want["opt"]["m"]),
             "v": tree_leaves(want["opt"]["v"])}
    unequal = {g: [k for k, (a, b) in enumerate(zip(groups[g], wants[g])) if not _bits_equal(a, b)]
               for g in groups}
    assert unequal["params"] == [n - 1] and unequal["m"] == unequal["v"] == []
    with pytest.raises(AssertionError):
        _assert_bits(got, want, got_m, want_m)


def test_shared_storage_raises_before_anything_is_written():
    cfg, model, opt, state, mesh = _setup("qwen3-8b", (2, 2), ("data", "model"))
    batch = _batch(cfg)
    step = steps.make_train_step(model, opt, donate=True)
    for tie in ("same", "view"):
        given = _copy(state)
        if tie == "same":  # one tensor for two leaves
            given["opt"]["v"]["final_norm"] = given["opt"]["m"]["final_norm"]
        else:  # views of one buffer
            buf = torch.zeros(2, *given["opt"]["m"]["final_norm"].shape)
            given["opt"]["m"]["final_norm"], given["opt"]["v"]["final_norm"] = buf[0], buf[1]
        before = [t.clone() for t in _pieces(given)]
        with pytest.raises(ValueError, match="share storage"):
            step(given, batch)
        assert all(_bits_equal(a, b) for a, b in zip(_pieces(given), before))
    # two pieces of one placed leaf that share storage
    s_sh, b_sh = _shardings(cfg, state, batch, mesh)
    placed = shd.place(_copy(state), s_sh)
    leaf = placed["params"]["final_norm"]
    assert leaf.sharding.spec == shd.P() or leaf.pieces.flat[0].shape == leaf.pieces.flat[1].shape
    leaf.pieces.flat[1] = leaf.pieces.flat[0]
    before = [t.clone() for t in _pieces(placed)]
    with pytest.raises(ValueError, match="share storage"):
        steps.make_sharded_train_step(model, opt, s_sh, b_sh, donate=True)(placed, batch)
    assert all(_bits_equal(a, b) for a, b in zip(_pieces(placed), before))


# ---------------------------------------------------------------- the sharded step


@pytest.mark.parametrize("name", ["adamw", "adamw_quant"])
@pytest.mark.parametrize("tp", [False, True], ids=["gather", "tp"])
@pytest.mark.parametrize("dims", MESHES, ids=["x".join(map(str, d)) for d in MESHES])
def test_the_donated_sharded_step_is_the_step_bit_for_bit(dims, tp, name):
    """Two steps from one placed state; every piece keeps its storage."""
    cfg, model, opt, state, mesh = _setup("qwen3-8b", dims, ("data", "model"), OPTS[name]())
    batches = [_batch(cfg, seed=i) for i in range(2)]
    step, donating, s_sh = _sharded_steps(model, opt, state, batches[0], mesh, cfg, tp)
    want, want_m, got, got_m, stayed = _run_both(step, donating, state, batches,
                                                 lambda s: shd.place(s, s_sh))
    _assert_bits(got, want, got_m, want_m)
    assert stayed and int(shd.gather(got["step"])) == 2


@pytest.mark.parametrize("name", ["sgd", "momentum_bf16"])
@pytest.mark.parametrize("tp", [False, True], ids=["gather", "tp"])
def test_element_wise_optimizers_donate_bit_for_bit(tp, name):
    cfg, model, opt, state, mesh = _setup("qwen3-8b", (2, 2), ("data", "model"), OPTS[name]())
    batches = [_batch(cfg, seed=i) for i in range(2)]
    step, donating, s_sh = _sharded_steps(model, opt, state, batches[0], mesh, cfg, tp)
    want, want_m, got, got_m, stayed = _run_both(step, donating, state, batches,
                                                 lambda s: shd.place(s, s_sh))
    _assert_bits(got, want, got_m, want_m)
    assert stayed


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_donates_bit_for_bit(family):
    """One reduced config a family: the unsharded step, and the
    tensor-parallel route on (2, 2) with quantized moments."""
    cfg, model, opt, state, mesh = _setup(FAMILIES[family], (2, 2), ("data", "model"),
                                          attn_chunk=8)
    batch = _batch(cfg, B=4, S=12)
    with use_mesh(mesh):
        want, want_m, got, got_m, stayed = _run_both(
            steps.make_train_step(model, opt), steps.make_train_step(model, opt, donate=True),
            state, [batch])
    _assert_bits(got, want, got_m, want_m)
    assert stayed
    opt = adamw(1e-3, quantize=True)
    state = dict(state, opt=opt.init(state["params"]))
    step, donating, s_sh = _sharded_steps(model, opt, state, batch, mesh, cfg, True)
    want, want_m, got, got_m, stayed = _run_both(step, donating, state, [batch],
                                                 lambda s: shd.place(s, s_sh))
    _assert_bits(got, want, got_m, want_m)
    assert stayed


def test_a_leaf_given_as_a_tensor_is_placed_and_left_untouched():
    """A tensor leaf, or one placed by another sharding, is placed first:
    its new pieces are written and the caller's leaf keeps its values;
    the leaves given placed by their sharding are written in place."""
    cfg, model, opt, state, mesh = _setup("qwen3-8b", (2, 2), ("data", "model"))
    batch = _batch(cfg)
    s_sh, b_sh = _shardings(cfg, state, batch, mesh)
    want, want_m = steps.make_sharded_train_step(model, opt, s_sh, b_sh)(_copy(state), batch)
    given = shd.place(_copy(state), s_sh)
    plain = given["params"]["embed"] = state["params"]["embed"].clone()
    other = shd.NamedSharding(mesh, shd.P())
    moved = given["opt"]["m"]["final_norm"] = shd.place(state["opt"]["m"]["final_norm"], other)
    kept = given["opt"]["v"]["embed"]
    before = (plain.clone(), [p.clone() for p in moved.pieces.flat], _layout(kept.pieces.flat))
    got, got_m = steps.make_sharded_train_step(model, opt, s_sh, b_sh, donate=True)(given, batch)
    _assert_bits(got, want, got_m, want_m)
    assert _bits_equal(plain, before[0])
    assert all(_bits_equal(p, q) for p, q in zip(moved.pieces.flat, before[1]))
    assert got["params"]["embed"] is not plain and got["opt"]["m"]["final_norm"] is not moved
    assert got["opt"]["v"]["embed"] is kept and _layout(kept.pieces.flat) == before[2]


# ---------------------------------------------------------------- the reference


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quant"])
def test_three_donated_steps_track_the_references_donated_jit(quant):
    """``tests/test_torch_train.py``'s three AdamW steps (its tiny qwen3,
    schedule and batches) with both steps donating, held by that test's
    three-step bounds: loss, ce and grad norm rtol 1e-5; params atol 1e-6
    (2e-5 with quantized moments); f32 moments rtol 1e-4 / atol 1e-7, bf16
    m rtol 2^-6 / atol 1e-5, int8 ``v_q`` one symbol apart on at most 1%."""
    jcfg, tcfg = _train_cfgs("qwen3-8b", **TINY)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jo, to = _train_opts(jopt, "adamw", quant), _train_opts(topt, "adamw", quant)
    jstate = jsteps.init_train_state(jm, jo, jax.random.key(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), "cpu")
    state = {"params": params, "opt": to.init(params), "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(jsteps.make_train_step(jm, jo), donate_argnums=(0,))
    step = steps.make_train_step(tm, to, donate=True)
    layout = _layout(_pieces(state))
    rng = np.random.RandomState(0)
    for _ in range(3):
        b = rng.randint(0, TINY["vocab_size"], (2, 24)).astype(np.int32)
        with warnings.catch_warnings():  # the CPU backend may not use every donated buffer
            warnings.filterwarnings("ignore", message=".*donated buffers were not usable")
            jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(b)})
        state, met = step(state, {"tokens": torch.from_numpy(b)})
        for k in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5)
    assert _layout(_pieces(state)) == layout and int(state["step"]) == int(jstate["step"]) == 3
    atol = 2e-5 if quant else 1e-6
    for a, b in zip(jax.tree.leaves(jstate["params"]), tree_leaves(state["params"])):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=atol)
    flips = total = 0
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jstate["opt"]),
                            tree_leaves(state["opt"])):
        if "v_q" in jax.tree_util.keystr(path):
            d = np.abs(b.numpy().astype(np.int32) - np.asarray(a).astype(np.int32))
            assert d.max() <= 1
            flips, total = flips + int((d > 0).sum()), total + d.size
        elif b.dtype == torch.bfloat16:
            np.testing.assert_allclose(_np(b), _np(a), rtol=2**-6, atol=1e-5)
        else:
            np.testing.assert_allclose(_np(b), _np(a), rtol=1e-4, atol=1e-7)
    assert flips <= 0.01 * max(total, 1)
