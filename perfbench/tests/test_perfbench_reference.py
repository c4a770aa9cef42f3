"""The benchmark's own pieces on the CPU: its token stream against the
program's generator, its weights against the program's param tree, and
the plain reference against the program's train step at small sizes."""

import ast

import numpy as np
import pbsmall
import pytest
import torch

from perfbench import check, spec, traffic, weights
from perfbench.kinds import markov_lm as K
from perfbench.reference import common as C
from perfbench.reference import train as ref_train
from perfbench.reference.layout import leaves

CONFIGS = ["stablelm-1.6b", "zamba2-2.7b"]


def test_the_stream_is_the_program_s_markov_chain():
    from repro_torch.data.lm import MarkovTokens

    theirs = MarkovTokens(97, seed=5).sample(np.random.RandomState(6), 3, 40)
    mine = traffic.MarkovTokens(97, seed=5).sample(np.random.RandomState(6), 3, 40)
    np.testing.assert_array_equal(mine, theirs)


def test_the_stream_repeats_by_seed_and_keeps_its_sizes():
    t = {"batch": 3, "seq": 17}
    a, b, c = (traffic.token_batches(50, t, s) for s in (2**31 + 7, 2**31 + 7, 11))
    first = [next(a) for _ in range(2)]
    assert all(np.array_equal(x, next(b)) for x in first)
    other = next(c)
    assert other.shape == first[0].shape and not np.array_equal(other, first[0])
    assert traffic.rows_all_differ(first)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_weights_are_the_program_s_tree_at_full_width(name):
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import train_state_shapes
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw

    cfg = spec.config(name)
    K.check_arch(cfg, get_arch(cfg["registry"]))
    shapes = train_state_shapes(build_model(get_arch(cfg["registry"])), adamw(1e-3))["params"]
    meta = {n: torch.empty(leaf.shape, dtype=getattr(torch, leaf.dtype), device="meta")
            for n, leaf in leaves(spec.family(cfg).layout(cfg))}
    K._check_tree(ref_train._tree(list(meta.items())), shapes)


def test_the_weights_repeat_by_seed():
    arch, cfg = pbsmall.small("zamba2-2.7b")
    lay = spec.family(cfg).layout(cfg)
    a, b, c = (weights.make(lay, s, "cpu") for s in (3, 3, 4))
    for (n, x), (_, y), (_, z) in zip(leaves(a), leaves(b), leaves(c)):
        assert torch.equal(x, y)
        if lay_leaf(lay, n).init not in ("ones", "zeros"):
            assert not torch.equal(x, z)


def lay_leaf(lay, name):
    return dict(leaves(lay))[name]


def _program_steps(name, steps, seed=9, **opt):
    arch, cfg = pbsmall.small(name)
    tr = pbsmall.small_traffic("markov.b4.s2048", batch=4, seq=24)
    tr["optimizer"] = dict(tr["optimizer"], **opt)
    tr["setup_steps"] = steps
    ctx = K.Ctx(cfg, tr, spec.family(cfg), tr["batch"], tr["seq"], torch.device("cpu"))
    o, state, step_fn = K._program(ctx, arch, seed)
    state, prog, hosts = K._setup_steps(ctx, state, step_fn, K._feed(ctx, seed))
    params = weights.make(ctx.family.layout(cfg), seed, "cpu")
    return ctx, prog, hosts, params


@pytest.mark.parametrize("name", CONFIGS)
def test_the_reference_follows_one_program_step(name):
    ctx, prog, hosts, params = _program_steps(name, 1, warmup=0)
    ref = ref_train.follow(ctx.family, ctx.cfg, ctx.traffic["optimizer"], params, hosts, "cpu")
    assert prog["loss"][0] == pytest.approx(ref["loss"][0], rel=1e-6)
    for u, r in ref["change"].items():  # the step moved every param as the reference's
        assert prog["change"][u] == pytest.approx(r, rel=2e-4, abs=1e-6), u
    found = check.gaps(prog, ref)
    assert max(v["value"] for v in found.values()) < 1e-4


@pytest.mark.parametrize("name", CONFIGS)
def test_the_fp8_control_reads_far_above_the_program(name):
    """The control at a size a test run holds: the reference with float8
    operands against the float32 reference, beside the program's own
    float32 readings and each of the configuration's cells' limits."""
    ctx, prog, hosts, params = _program_steps(name, 3)
    follow = lambda **kw: ref_train.follow(ctx.family, ctx.cfg, ctx.traffic["optimizer"],  # noqa: E731
                                           params, hosts, "cpu", **kw)
    ref = follow()
    sound = {k: v["value"] for k, v in check.gaps(prog, ref).items()}
    control = {k: v["value"] for k, v in check.gaps(follow(prec=C.Prec("fp8")), ref).items()}
    assert max(control[k] / max(sound[k], 1e-12) for k in check.NUMBERS) > 100
    for cell in (w["name"] for w in spec.benchmark()["workloads"] if w["config"] == name):
        limits = spec.limits(cell)
        assert not check.decide({k: {"value": v} for k, v in control.items()}, limits)[0] \
            or not limits


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                assert not any(n.split(".")[0] in ("repro_torch", "repro", "jax") for n in names), \
                    (path.name, names)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in spec.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                for n in names:
                    assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "repro"), (path, n)


def test_a_run_loads_no_jax_module():
    """A whole small run in a process of its own: no module whose top-level
    name is JAX's or the JAX package's is loaded (``repro_torch`` is not
    ``repro``)."""
    import subprocess
    import sys

    code = (
        "import pbsmall, sys\n"
        "from perfbench import run, spec\n"
        "from perfbench.kinds import markov_lm as K\n"
        "arch, cfg = pbsmall.small('stablelm-1.6b')\n"
        "tr = pbsmall.small_traffic('markov.b4.s2048', batch=4, seq=16)\n"
        "out = K.run(cfg, tr, seed=5, seconds=0.05, trace=False, device='cpu', t0=0.0,"
        " arch=arch)\n"
        "assert 'repro_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=pbsmall.ROOT / "perfbench" / "tests",
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
