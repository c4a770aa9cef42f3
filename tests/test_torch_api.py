"""Parity of the FL data plane's remaining public API with the JAX
reference, on the CPU: the tree-level quantizers, the batch wire codec,
the uplink aliases, the per-tree OTA oracle and the channel accounting;
and an AST diff of both packages' public names, which lists every name
that stays absent from the port on purpose, with its reason.

The reference's quantizers divide by ``qmax`` eagerly; the port
multiplies by its f32 reciprocal, as the reference's jitted programs do,
so the port is held bit for bit against ``jax.jit`` of the reference.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ota as jota
from repro.core import packing as jpacking
from repro.core import quant as jquant
from repro.core import wire as jwire
from repro_torch import configs as tconfigs
from repro_torch.core import ota as tota
from repro_torch.core import packing as tpacking
from repro_torch.core import quant as tquant
from repro_torch.core import wire as twire
from repro_torch.core.tree import tree_flatten
from test_torch_fl import JaxDraws

ROOT = pathlib.Path(__file__).resolve().parent.parent
BITS = (4, 8, 16)


def _tree_np(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {
        "a": (rng.randn(4, 33) * scale).astype(np.float32),
        "b": [(rng.randn(77) * scale).astype(np.float32),
              (rng.randn(3, 5, 2) * scale).astype(np.float32)],
        "c": (rng.randn(1) * scale).astype(np.float32),
    }


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _leaves_np(tree):
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return [t.numpy() for t in tree_flatten(tree)[0]]
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# ---------------------------------------------------------------- quant


@pytest.mark.parametrize("bits", BITS + (32,))
@pytest.mark.parametrize("seed", [0, 1])
def test_tree_quantizers_equal_the_jitted_reference(bits, seed):
    arrays = _tree_np(seed, scale=10.0 ** (seed - 1))
    jt, tt = _to_jax(arrays), _to_torch(arrays)
    jq, js = jax.jit(lambda t: jquant.quantize_tree(t, bits))(jt)
    tq, ts = tquant.quantize_tree(tt, bits)
    for a, b in zip(_leaves_np(jq), _leaves_np(tq)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves_np(js), _leaves_np(ts)):
        np.testing.assert_array_equal(a, b)
    jd = jax.jit(lambda q, s: jquant.dequantize_tree(q, s, bits))(jq, js)
    for a, b in zip(_leaves_np(jd), _leaves_np(tquant.dequantize_tree(tq, ts, bits))):
        np.testing.assert_array_equal(a, b)
    jf = jax.jit(lambda t: jquant.fake_quant_tree(t, bits))(jt)
    for a, b in zip(_leaves_np(jf), _leaves_np(tquant.fake_quant_tree(tt, bits))):
        np.testing.assert_array_equal(a, b)
    x = tt["b"][0]
    want = float(jax.jit(lambda v: jquant.quant_error(v, bits))(jt["b"][0]))
    assert abs(float(tquant.quant_error(x, bits)) - want) <= 1e-6


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_stochastic_rounding_unbiased_over_64_generators(bits, seed):
    """E[fq_stochastic(x)] == x within the CLT bound of the reference's
    ``tests/test_quant.py`` (64 draws, 5 sigma)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(8 + seed % 393) * 10.0 ** (seed % 3 - 1)).astype(np.float32))
    fqs = torch.stack([
        tquant.fake_quant(x, bits, generator=torch.Generator().manual_seed(g))
        for g in range(64)
    ])
    mean = fqs.mean(dim=0)
    _, scale = tquant.quantize(x, bits)
    tol = 5 * float(scale) / (2 * np.sqrt(64)) + 1e-6
    inside = x.abs() <= (tquant.qrange(bits) - 1) * scale
    assert float(torch.where(inside, (mean - x).abs(), torch.zeros_like(x)).max()) <= tol
    # stochastic symbols are floor or floor + 1 of the nearest grid's
    q, _ = tquant.quantize(x, bits, generator=torch.Generator().manual_seed(0))
    q_near, _ = tquant.quantize(x, bits)
    assert int((q - q_near).abs().max()) <= 1


def test_a_tree_generator_is_consumed_leaf_by_leaf_in_flatten_order():
    tt = _to_torch(_tree_np(3))
    got = tquant.fake_quant_tree(tt, 4, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    want = [tquant.fake_quant(leaf, 4, generator=gen) for leaf in tree_flatten(tt)[0]]
    for a, b in zip(tree_flatten(got)[0], want):
        assert torch.equal(a, b)
    assert tquant.fake_quant_tree(tt, 32) is tt


# ---------------------------------------------------------------- wire


def _rows(k, m, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(k, m) * np.logspace(-2, 1, k)[:, None]).astype(np.float32)


def _same_packed(jrow, trow):
    assert (jrow.bits, jrow.qblock, jrow.kind, jrow.wire_nbytes) == (
        trow.bits, trow.qblock, trow.kind, trow.wire_nbytes)
    np.testing.assert_array_equal(np.asarray(jrow.data), trow.data.numpy())
    np.testing.assert_array_equal(np.asarray(jrow.scale), trow.scale.numpy())


@pytest.mark.parametrize("block", [0, 64])
def test_encode_rows_and_decode_rows_equal_the_reference(block):
    X = _rows(5, 1000, 11)
    bits = [4, 8, 16, 32, 3]
    seed = 0x9E3779B9
    jrows = jwire.encode_rows(list(jnp.asarray(X)), bits, jnp.uint32(seed), block=block,
                              first_row=3)
    trows = twire.encode_rows(list(torch.from_numpy(X)), bits, seed, block=block, first_row=3)
    for jr, tr in zip(jrows, trows):
        _same_packed(jr, tr)
    # row j dithers as row first_row + j
    _same_packed(jrows[1], twire.encode_row(torch.from_numpy(X[1]), 8, seed, 4, block=block))
    for a, b in zip(jwire.decode_rows(jrows, 999), twire.decode_rows(trows, 999)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert twire.wire_bytes(trows) == jwire.wire_bytes(jrows)


@pytest.mark.parametrize("bits", BITS + (32,))
def test_uplink_aliases_equal_the_reference(bits):
    row = _rows(1, 4096 + 37, bits)[0]
    seed = 123456789
    jr = jota.quantize_uplink(jnp.asarray(row), bits, jnp.uint32(seed), 2,
                              block=jpacking.QUANT_BLOCK)
    tr = tota.quantize_uplink(torch.from_numpy(row), bits, seed, 2, block=tpacking.QUANT_BLOCK)
    _same_packed(jr, tr)
    np.testing.assert_array_equal(np.asarray(jota.dequantize_uplink(jr, 4100)),
                                  tota.dequantize_uplink(tr, 4100).numpy())
    assert tr.wire_nbytes == tpacking.row_wire_bytes(bits, row.shape[0], tpacking.QUANT_BLOCK)
    # the reconstruction is within one scale of the row (up to the f32
    # rounding of x / scale and q * scale, chip_smoke.uplink_error_bound)
    dq = tota.dequantize_uplink(tr, row.shape[0])
    scale = tr.scale.reshape(-1).repeat_interleave(tpacking.QUANT_BLOCK)[: row.shape[0]]
    x = torch.from_numpy(row)
    bound = scale + 2.0**-23 * (x.abs() + 2 * scale) if bits < 32 else torch.zeros_like(x)
    assert bool(((dq - x).abs() <= bound).all())


# ---------------------------------------------------------------- ota


def _mixed_updates(n, seed=0):
    rng = np.random.RandomState(seed)
    return [
        {"a": rng.randn(4, 33).astype(np.float32),
         "b": [rng.randn(77).astype(np.float32), rng.randn(3, 5, 2).astype(np.float32)]}
        for _ in range(n)
    ]


@pytest.mark.parametrize("snr", [80.0, 15.0])
def test_pertree_oracle_equals_the_reference(snr):
    ups = _mixed_updates(6)
    bits = [4, 8, 16, 32, 8, 4]
    weights = [1.0, 2.0, 0.5, 1.0, 3.0, 1.5]
    cfg_j, cfg_t = jota.OTAConfig(snr_db=snr), tota.OTAConfig(snr_db=snr)
    jtree, jinfo = jota.ota_aggregate_pertree(jax.random.key(123), [_to_jax(u) for u in ups],
                                              bits, weights, cfg_j)
    tups = [_to_torch(u) for u in ups]
    ttree, tinfo = tota.ota_aggregate_pertree(JaxDraws(123), tups, bits, weights, cfg_t)
    assert jinfo["participation"] == tinfo["participation"]
    assert jinfo["n_participating"] == tinfo["n_participating"]
    assert abs(jinfo["noise_std"] - tinfo["noise_std"]) < 1e-6
    for a, b in zip(_leaves_np(jtree), _leaves_np(ttree)):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    # the port's own flat path, with the same draws
    flat, finfo = tota.ota_aggregate(JaxDraws(123), tups, bits, weights, cfg_t)
    assert finfo["participation"] == tinfo["participation"]
    assert abs(finfo["noise_std"] - tinfo["noise_std"]) < 1e-6
    for a, b in zip(_leaves_np(flat), _leaves_np(ttree)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_channel_accounting():
    assert tota.channel_uses([4, 8, 16, 32], 1000) == jota.channel_uses([4, 8, 16, 32], 1000)
    assert tota.channel_uses([8], 1000) == 1000
    for bits in ([8, 8], [4, 16, 32], []):
        assert tota.digital_uplink_bits(bits, 4133952) == jota.digital_uplink_bits(bits, 4133952)
    assert tota.digital_uplink_bits([8, 8], 1000) == 16000


def test_fl_config_fields_equal_the_reference():
    from repro.configs.base import FLConfig as JFL

    t, j = tconfigs.FLConfig(), JFL()
    assert t.categories == j.categories and t.category_probs == j.category_probs


# ---------------------------------------------------------------- names

REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

TPU_CONSTANTS = ("a TPU v5e's peak rates for the reference's roofline; the card's constants "
                 "are launch/mesh.py's CARD_*")
XLA_ONLY = ("an XLA artifact of the reference's dry run (the compiled HLO, its cost and "
            "memory analyses); the port's dry run runs on meta tensors and compiles nothing")
JAX_KEY = "a jax.random key split; the port's round-draws seam (RoundDraws) replaces it"
PALLAS = "a Pallas kernel or its TPU tile constant; the port's CUDA wrapper takes its place"

MODULES_ABSENT = {
    "kernels/ref.py": "the reference's oracles; each port wrapper's plain version sits beside it",
}

NAMES_ABSENT = {
    ("core/channel.py", "derive_channel_key"): JAX_KEY,
    ("core/ota.py", "derive_sr_seed"): JAX_KEY,
    ("core/ota.py", "derive_dl_seed"): JAX_KEY,
    ("core/ota.py", "sample_channel"): JAX_KEY,
    ("obs/metrics.py", "install_jax_hooks"): "a jax.monitoring hook; PyTorch has no jit retrace",
    ("obs/export.py", "write_all_bench_reports"):
        "imports benchmarks/bench_*, which run the JAX package; waits for the port's benches",
    ("obs/export.py", "BENCH_REPORTS"): "the bench list of write_all_bench_reports",
    ("kernels/flash_attention.py", "flash_attention"): PALLAS,
    ("kernels/flash_attention.py", "BQ"): PALLAS,
    ("kernels/ota_aggregate.py", "BLOCK_COLS"): PALLAS,
    ("kernels/ota_aggregate.py", "LANES"): PALLAS,
    ("kernels/ota_fused.py", "BLOCK_COLS"): PALLAS,
    ("kernels/ota_fused.py", "LANES"): PALLAS,
    ("kernels/ota_fused.py", "ota_packed_2d"): PALLAS,
    ("kernels/ota_fused.py", "ota_fold_2d"): PALLAS,
    ("kernels/ota_fused.py", "ota_fused_2d"): PALLAS,
    ("kernels/quantize.py", "BLOCK_ROWS"): PALLAS,
    ("kernels/quantize.py", "LANES"): PALLAS,
    ("kernels/topk_similarity.py", "TOPK_LANES"): PALLAS,
    ("kernels/topk_similarity.py", "topk_similarity_2d"): PALLAS,
    ("util.py", "constrain"):
        "a GSPMD placement hint (with_sharding_constraint); a single controller places "
        "tensors explicitly (launch.sharding.place), so there is nothing to bind it to",
    ("util.py", "split_like"): JAX_KEY,
    ("launch/dryrun.py", "collective_bytes"): XLA_ONLY + ": it parses the HLO's collectives",
    ("launch/mesh.py", "PEAK_FLOPS_BF16"): TPU_CONSTANTS,
    ("launch/mesh.py", "HBM_BW"): TPU_CONSTANTS,
    ("launch/mesh.py", "ICI_BW"): TPU_CONSTANTS,
    ("launch/steps.py", "Pytree"): "a type alias (Any) the port's module does not annotate with",
    ("serve/engine.py", "Pytree"): "a type alias (Any) the port's module does not annotate with",
}

MEMBERS_ABSENT = {}

# the reference's dry run's private XLA-only helpers and record fields,
# none of which the port's has (held by a test below)
DRYRUN_XLA_ONLY = {
    "_compile_costs": XLA_ONLY + ": lowered.compile(), cost_analysis, memory_analysis",
    "_calib_cfgs": XLA_ONLY + ": unrolled 1- and 2-unit variants, since scans hide a "
                   "layer's cost from XLA's analysis",
    "_extrapolate": XLA_ONLY + ": the calibration's depth extrapolation",
    "_COLLECTIVES": XLA_ONLY + ": the HLO collective op names",
    "flops": XLA_ONLY, "bytes_accessed": XLA_ONLY, "collectives": XLA_ONLY,
    "temp_size_in_bytes": XLA_ONLY, "compile_s": XLA_ONLY, "t_collective_s": XLA_ONLY,
}

# the reference's type alias and the port's
ALIASES = {"Pytree": "Tree"}

# the names of the slices since PR 22, held to the reference's parameters;
# the port takes a torch.Generator for a key, a device for a sharding
# target, and the round-draws seam for a round key
SLICE = {
    "ckpt/checkpoint.py": ("save_checkpoint", "load_checkpoint", "CheckpointManager.__init__",
                           "CheckpointManager.path", "CheckpointManager.save",
                           "CheckpointManager.latest_step", "CheckpointManager.restore_latest"),
    "core/quant.py": ("quantize", "dequantize", "fake_quant", "quantize_tree",
                      "dequantize_tree", "fake_quant_tree", "quant_error", "quantize_state",
                      "dequantize_state"),
    "core/wire.py": ("encode_rows", "decode_rows"),
    "core/ota.py": ("quantize_uplink", "dequantize_uplink", "ota_aggregate_pertree",
                    "channel_uses", "digital_uplink_bits"),
    "obs/trace.py": ("traced", "get_tracer", "disabled", "Tracer.enable", "Tracer.disable",
                     "Tracer.span", "Tracer.span_names", "Tracer.export_perfetto"),
    "obs/metrics.py": ("Registry.get", "Registry.reset"),
    "obs/export.py": ("JsonlSink.__init__", "JsonlSink.emit", "summary", "dump_telemetry",
                      "write_bench_report"),
    "retrieval/arena.py": ("ArenaStore.save", "ArenaStore.load"),
    "retrieval/store.py": ("ArenaVectorStore.save", "ArenaVectorStore.restore"),
    "optim/optimizers.py": ("sgd", "momentum", "adam", "adamw", "constant_schedule",
                            "cosine_schedule", "linear_warmup_cosine", "clip_by_global_norm",
                            "state_nbytes"),
    "launch/steps.py": ("init_train_state", "train_state_shapes", "make_train_step"),
    "models/transformer.py": ("lm_logits_and_aux", "lm_loss"),
    "models/layers.py": ("apply_mrope", "moe_block", "moe_uses_shard_map"),
    "launch/sharding.py": ("param_spec", "tree_param_specs", "batch_spec", "cache_spec",
                           "to_named"),
    "launch/mesh.py": ("make_production_mesh", "make_host_mesh"),
    "launch/dryrun.py": ("model_flops", "active_params"),
    "util.py": ("get_abstract_mesh", "use_mesh", "dtype_of", "tree_size", "tree_bytes",
                "count_params"),
    "data/lm.py": ("MarkovTokens.__init__", "MarkovTokens.sample", "token_batches"),
}
RENAMES = {"key": "generator", "shardings": "device"}
RENAMES_OTA = {"key": "draws"}


def _defs(path):
    """Top-level public definitions: name -> node."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _imported(path):
    return {
        (a.asname or a.name)
        for node in ast.parse(path.read_text()).body
        if isinstance(node, ast.ImportFrom)
        for a in node.names
    }


def _ref_names(path):
    """The reference's public names: its definitions, and what a package
    ``__init__`` re-exports."""
    names = set(_defs(path))
    if path.name == "__init__.py":
        names |= {n for n in _imported(path) if not n.startswith("_")}
    return names


def _port_names(path):
    """Every name bound at the port module's top level."""
    return set(_defs(path)) | _imported(path)


def _members(cls):
    out = {}
    for node in cls.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node
    return {k: v for k, v in out.items() if not k.startswith("_") or k == "__init__"}


def _module_pairs():
    """(key, reference files, port file) for every reference module; the
    reference's ``configs/`` package is the port's ``configs.py``."""
    pairs = [("configs", [REF / "configs" / "__init__.py", REF / "configs" / "base.py",
                          REF / "configs" / "all_archs.py"], PORT / "configs.py")]
    for p in sorted(REF.rglob("*.py")):
        rel = p.relative_to(REF).as_posix()
        if rel.startswith("configs/"):
            continue
        pairs.append((rel, [p], PORT / rel))
    return pairs


def test_every_reference_module_is_ported_or_listed():
    missing = {key for key, _, port in _module_pairs() if not port.exists()}
    assert missing == set(MODULES_ABSENT)


def test_every_reference_name_is_ported_or_listed():
    absent = {}
    for key, refs, port in _module_pairs():
        if not port.exists():
            continue
        want = set().union(*(_ref_names(r) for r in refs))
        have = _port_names(port)
        for name in sorted(want - have):
            if ALIASES.get(name) in have:
                continue
            absent[(key, name)] = None
    assert set(absent) == set(NAMES_ABSENT), (
        sorted(set(absent) - set(NAMES_ABSENT)), sorted(set(NAMES_ABSENT) - set(absent)))


def test_every_reference_class_member_is_ported_or_listed():
    absent = set()
    for key, refs, port in _module_pairs():
        if not port.exists():
            continue
        pdefs = _defs(port)
        for r in refs:
            for name, node in _defs(r).items():
                if not isinstance(node, ast.ClassDef) or not isinstance(pdefs.get(name),
                                                                         ast.ClassDef):
                    continue
                have = _members(pdefs[name])
                absent |= {(key, name, m) for m in _members(node) if m not in have}
    assert absent == set(MEMBERS_ABSENT), (
        sorted(absent - set(MEMBERS_ABSENT)), sorted(set(MEMBERS_ABSENT) - absent))


def test_the_dry_runs_xla_only_names_are_the_references_alone():
    """Each listed XLA-only helper or record field of the reference's dry
    run is there, and the port's dry run has none of them."""
    ref = (REF / "launch" / "dryrun.py").read_text()
    port = (PORT / "launch" / "dryrun.py").read_text()
    for name in DRYRUN_XLA_ONLY:
        quoted = (f'"{name}"', f"'{name}'", f"def {name}(", f"{name} =")
        assert any(q in ref for q in quoted), name
        assert not any(q in port for q in quoted), name


def test_every_reference_config_is_registered_or_queued():
    registered = set()
    for p in (REF / "configs").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "register_arch"):
                registered.add(node.args[0].value)
    assert registered - set(tconfigs.ARCH_REGISTRY) == set()


def _signature(node):
    a = node.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    return pos, len(a.defaults), [x.arg for x in a.kwonlyargs], a.vararg is not None, \
        a.kwarg is not None


def _lookup(path, dotted):
    defs = _defs(path)
    head, _, member = dotted.partition(".")
    node = defs[head]
    return _members(node)[member] if member else node


@pytest.mark.parametrize("module", sorted(SLICE))
def test_this_slice_keeps_the_reference_signatures(module):
    renames = RENAMES_OTA if module == "core/ota.py" else RENAMES
    for name in SLICE[module]:
        ref = _signature(_lookup(REF / module, name))
        port = _signature(_lookup(PORT / module, name))
        added = PARAM_DIFFS.get((module, name), ({}, (), (), None))[2]
        port = (port[0], port[1], [n for n in port[2] if n not in added]) + port[3:]
        want = ([renames.get(n, n) for n in ref[0]], ref[1],
                [renames.get(n, n) for n in ref[2]], ref[3], ref[4])
        assert port == want, (module, name, port, want)


# ---------------------------------------------------------------- parameters

# Every function and method that both packages define keeps the
# reference's parameters, but for these stated differences: per function,
# (renamed {reference: port}, dropped reference parameters, added port
# parameters, reason). ``use_kernel`` is never one of them.
GEN = "a jax.random key; the port draws from a torch.Generator"
SHARDING = "a JAX sharding target; the port loads onto a torch device"
DEVICE = "the port's tensors live on an explicit device (the card unless the caller asks for the CPU)"
LEAD = ("and the layer axes (lead) the port draws a stack in place with; the reference vmaps "
        "per-layer keys")
SEAMS = "the seams the parity tests use: given weights and the reference's round draws"
INTERPRET = "Pallas interpret mode; a CUDA kernel has none (CPU tensors run the plain version)"
ARGV = "the CLI takes its arguments, so a test drives it in process"
CHUNK_CONTROLS = ("q_offset has no caller outside the reference's layers.py; block_skip, "
                  "differentiable, max_unroll and unroll_kv are XLA loop controls")
KEY_DRAWS = {"key": "draws"}
MESH_DEVICES = ("the shards' devices, which may repeat one device (['cpu'] * n on the CPU, "
                "[cuda:0] * n on one card): the port's counterpart of the reference's forced "
                "host device count; None spans n distinct cards and raises where fewer are "
                "visible, as the reference does")
SERVER_MESH = ("a data mesh in place of the knob's, such as several shards on one card, "
               "which the knob's distinct cards cannot give")

PARAM_DIFFS = {
    ("ckpt/checkpoint.py", "load_checkpoint"): ({"shardings": "device"}, (), (), SHARDING),
    ("ckpt/checkpoint.py", "CheckpointManager.restore_latest"):
        ({"shardings": "device"}, (), (), SHARDING),
    ("core/channel.py", "ChannelModel.sample"): ({"round_key": "draws"}, (), (), JAX_KEY),
    ("core/ota.py", "ota_aggregate_flat"): (KEY_DRAWS, (), (), JAX_KEY),
    ("core/ota.py", "round_channel"): (KEY_DRAWS, (), (), JAX_KEY),
    ("core/ota.py", "OtaAccumulator.finalize"): (KEY_DRAWS, (), (), JAX_KEY),
    ("core/ota.py", "ota_aggregate_packed"): (KEY_DRAWS, (), (), JAX_KEY),
    ("core/ota.py", "ota_aggregate"): (KEY_DRAWS, (), (), JAX_KEY),
    ("core/ota.py", "ota_aggregate_pertree"): (KEY_DRAWS, (), (), JAX_KEY),
    ("core/profiling/planner.py", "RAGPlanner.__init__"): ({}, (), ("device",), DEVICE),
    ("core/quant.py", "quantize"): ({"key": "generator"}, (), (), GEN),
    ("core/quant.py", "fake_quant"): ({"key": "generator"}, (), (), GEN),
    ("core/quant.py", "quantize_tree"): ({"key": "generator"}, (), (), GEN),
    ("core/quant.py", "fake_quant_tree"): ({"key": "generator"}, (), (), GEN),
    ("fl/server.py", "make_planner"): ({}, (), ("device",), DEVICE),
    ("fl/server.py", "FLServer.__init__"):
        ({}, (), ("device", "init_params", "draws", "mesh"),
         DEVICE + "; " + SEAMS + "; " + SERVER_MESH),
    ("fl/server.py", "StreamingFLServer.__init__"):
        ({}, ("shard_size",), ("**kw",),
         "shard_size, the device and the seams pass through **kw to FLServer.__init__"),
    ("kernels/ops.py", "fake_quant"): ({"key": "generator"}, (), (), GEN),
    ("kernels/ota_aggregate.py", "ota_aggregate_2d"): ({}, ("interpret",), (), INTERPRET),
    ("kernels/qmatmul.py", "qmatmul"): ({}, ("interpret",), (), INTERPRET),
    ("kernels/quantize.py", "fake_quant_2d"): ({}, ("interpret",), (), INTERPRET),
    ("launch/mesh.py", "make_data_mesh"): ({}, (), ("devices",), MESH_DEVICES),
    ("launch/mesh.py", "make_mesh"): ({}, (), ("devices",), MESH_DEVICES + "; or 'meta' "
                                      "(shapes only, the dry run's devices)"),
    ("launch/dryrun.py", "dryrun_one"):
        ({}, ("calibrate",), (), XLA_ONLY + ": calibrate= runs the unrolled cost lowerings"),
    ("launch/dryrun.py", "main"): ({}, (), ("argv",), ARGV),
    ("launch/serve.py", "main"): ({}, (), ("argv",), ARGV),
    ("launch/train.py", "main"): ({}, (), ("argv",), ARGV),
    ("launch/steps.py", "init_train_state"): ({"key": "generator"}, (), (), GEN),
    ("launch/steps.py", "make_train_step"):
        ({}, (), ("donate",), "the reference donates through jax.jit(..., donate_argnums=(0,)); "
         "the port's step takes the donation itself and writes the state in place"),
    ("models/deepspeech2.py", "init_gru"): ({"key": "gen"}, (), ("device",), GEN + "; " + DEVICE),
    ("models/deepspeech2.py", "init_ds2"): ({"key": "gen"}, (), ("device",), GEN + "; " + DEVICE),
    ("models/hybrid.py", "init_hybrid"): ({"key": "gen"}, (), ("device",), GEN + "; " + DEVICE),
    ("models/hybrid.py", "init_hybrid_cache"): ({}, (), ("device",), DEVICE),
    ("models/layers.py", "dense_init"):
        ({"key": "gen"}, ("scale",), ("device",),
         GEN + "; " + DEVICE + "; no scale: the port's ssm init reaches the same std through "
         "fan-in (models/ssm.py)"),
    ("models/layers.py", "embed_init"): ({"key": "gen"}, (), ("device",), GEN + "; " + DEVICE),
    ("models/layers.py", "rope_freqs"): ({}, (), ("device",), DEVICE),
    ("models/layers.py", "chunked_attention"):
        ({}, ("q_offset", "block_skip", "differentiable", "max_unroll", "unroll_kv"), (),
         CHUNK_CONTROLS),
    ("models/layers.py", "init_attention"):
        ({"key": "gen"}, (), ("device", "lead"), GEN + "; " + DEVICE + ", " + LEAD),
    ("models/layers.py", "init_mlp"):
        ({"key": "gen"}, (), ("device", "lead"), GEN + "; " + DEVICE + ", " + LEAD),
    ("models/layers.py", "init_moe"):
        ({"key": "gen"}, (), ("device", "lead"), GEN + "; " + DEVICE + ", " + LEAD),
    ("models/ssm.py", "init_mamba1"):
        ({"key": "gen"}, (), ("device", "lead"), GEN + "; " + DEVICE + ", " + LEAD),
    ("models/ssm.py", "init_mamba2"):
        ({"key": "gen"}, (), ("device", "lead"), GEN + "; " + DEVICE + ", " + LEAD),
    ("models/transformer.py", "init_lm"): ({"key": "gen"}, (), ("device",), GEN + "; " + DEVICE),
    ("models/transformer.py", "init_decode_cache"): ({}, (), ("device",), DEVICE),
    ("models/whisper.py", "init_whisper"): ({"key": "gen"}, (), ("device",), GEN + "; " + DEVICE),
    ("models/whisper.py", "init_whisper_cache"): ({}, (), ("device",), DEVICE),
    ("retrieval/engine.py", "RetrievalEngine.__init__"): ({}, (), ("device",), DEVICE),
    ("retrieval/store.py", "ArenaVectorStore.__init__"): ({}, (), ("device",), DEVICE),
    ("serve/engine.py", "ServeEngine.__init__"):
        ({}, (), ("device", "params"), DEVICE + "; " + SEAMS),
}


def _params(node):
    """(name, kind, has a default) of each parameter, in order; ``*args``
    and ``**kw`` by their starred names."""
    a = node.args
    pos = a.posonlyargs + a.args
    first_default = len(pos) - len(a.defaults)
    out = [(x.arg, "pos", i >= first_default) for i, x in enumerate(pos)]
    if a.vararg is not None:
        out.append(("*" + a.vararg.arg, "var", False))
    out += [(x.arg, "kw", d is not None) for x, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg is not None:
        out.append(("**" + a.kwarg.arg, "varkw", False))
    return out


def _shared_functions():
    """(module key, dotted name, reference node, port node) of every
    public function and method that both packages define."""
    out = []
    for key, refs, port in _module_pairs():
        if not port.exists():
            continue
        pdefs = _defs(port)
        for r in refs:
            for name, node in _defs(r).items():
                pnode = pdefs.get(name)
                if isinstance(node, ast.FunctionDef) and isinstance(pnode, ast.FunctionDef):
                    out.append((key, name, node, pnode))
                elif isinstance(node, ast.ClassDef) and isinstance(pnode, ast.ClassDef):
                    have = _members(pnode)
                    for m, mnode in _members(node).items():
                        if isinstance(mnode, ast.FunctionDef) and isinstance(
                                have.get(m), ast.FunctionDef):
                            out.append((key, f"{name}.{m}", mnode, have[m]))
    return out


def test_every_shared_function_keeps_the_reference_parameters():
    """Names, order, kinds and defaults of every parameter of the ~290
    functions and methods both packages define, after each listed
    difference is applied; no difference goes unlisted, and no listed one
    is stale."""
    shared = _shared_functions()
    assert len(shared) >= 280
    seen = set()
    for key, name, ref, port in shared:
        renamed, dropped, added, reason = PARAM_DIFFS.get((key, name), ({}, (), (), None))
        want = [(renamed.get(n, n), kind, d) for n, kind, d in _params(ref) if n not in dropped]
        got = [p for p in _params(port) if p[0] not in added]
        assert got == want, (key, name, got, want)
        assert {p[0] for p in _params(port)} >= set(added), (key, name)
        if reason is not None:
            seen.add((key, name))
    assert seen == set(PARAM_DIFFS), sorted(set(PARAM_DIFFS) - seen)
    for renamed, dropped, added, _ in PARAM_DIFFS.values():
        assert "use_kernel" not in set(renamed) | set(dropped) | set(added)


def test_every_listed_parameter_difference_is_one():
    """Each listed function differs from the reference without its entry."""
    for key, name, ref, port in _shared_functions():
        if (key, name) in PARAM_DIFFS:
            assert _params(ref) != _params(port), (key, name)
