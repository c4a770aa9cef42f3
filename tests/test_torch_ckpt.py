"""Checkpoints cross between the JAX package and the PyTorch port, on the
CPU: a file either package writes loads in the other bit for bit, in
every dtype the data plane stores, and the decompressed documents are
byte-identical (leaf order is ``jax.tree.flatten``'s, bf16 is stored
natively under ``bf16n``). The port's msgpack subset is held byte for
byte against ``msgpack.packb(use_bin_type=True)``, and the port still
round-trips a checkpoint with ``msgpack`` and ``zstandard`` blocked.
Arena and RAG feedback-database files cross too, and a restored database
answers queries as the saved one did.
"""

import importlib
import os
import sys
import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import zstandard

from repro.ckpt import checkpoint as jck
from repro.core.profiling.ragdb import ContextQuantFeedbackDB as JDB
from repro.retrieval.arena import ArenaStore as JArena
from repro.retrieval.engine import RetrievalEngine as JEngine
from repro_torch.ckpt import _msgpack
from repro_torch.ckpt import checkpoint as tck
from repro_torch.core.profiling.ragdb import ContextQuantFeedbackDB as TDB
from repro_torch.core.tree import tree_flatten
from repro_torch.retrieval.arena import ArenaStore as TArena
from repro_torch.retrieval.engine import RetrievalEngine as TEngine

DTYPES = ("float32", "bfloat16", "int8", "int16", "int32", "uint32")
META = {"note": "round 7", "step": 7, "lr": 5e-4, "neg": -129, "flags": [True, None],
        "blob": b"\x00\xff", "nested": {"k": list(range(20))}}


def _values(dtype, shape, rng):
    if dtype in ("float32", "bfloat16"):
        return np.asarray(rng.randn(*shape), np.float32)
    info = np.iinfo(dtype)
    return np.asarray(rng.randint(info.min, info.max, size=shape, dtype=np.int64), dtype)


def _trees(dtype, seed=0):
    """The same nested dict/list/tuple tree as jax arrays and torch tensors."""
    rng = np.random.RandomState(seed)
    shapes = {"w": (3, 5), "b": (5,), "list": [(2, 2), (1,)], "tup": ((), (4, 1, 2))}
    arrays = {
        "w": _values(dtype, shapes["w"], rng),
        "b": _values(dtype, shapes["b"], rng),
        "list": [_values(dtype, s, rng) for s in shapes["list"]],
        "tup": tuple(_values(dtype, s, rng) for s in shapes["tup"]),
    }
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jt = jax.tree.map(lambda a: jnp.asarray(a, jdt), arrays)
    tt = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), arrays)
    return {"params": jt, "opt": [jt["b"]]}, {"params": tt, "opt": [tt["b"]]}


def _doc(path):
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:1] == b"Z"
    return zstandard.ZstdDecompressor().decompress(blob[1:])


def _bits(x):
    """A leaf's raw bytes and dtype name, from either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes(), tuple(x.shape)
        return str(x.dtype).replace("torch.", ""), x.numpy().tobytes(), tuple(x.shape)
    a = np.asarray(x)
    return str(a.dtype), a.tobytes(), a.shape


def _same_tree(jtree, ttree):
    jl, jdef = jax.tree.flatten(jtree)
    tl, tstruct = tree_flatten(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert _bits(a) == _bits(b)
    # the same containers: the port's tree rebuilt with jax leaves
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ttree)) == jdef


@pytest.mark.parametrize("dtype", DTYPES)
def test_checkpoints_cross_both_ways_bit_for_bit(tmp_path, dtype):
    jtree, ttree = _trees(dtype)
    jp, tp = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jck.save_checkpoint(jp, jtree, meta=META)
    tck.save_checkpoint(tp, ttree, meta=META)
    assert _doc(jp) == _doc(tp)
    got_t, meta_t = tck.load_checkpoint(jp, device="cpu")
    got_j, meta_j = jck.load_checkpoint(tp)
    assert meta_t == meta_j == META
    _same_tree(jtree, got_t)
    _same_tree(got_j, ttree)
    if dtype == "bfloat16":
        enc = msgpack.unpackb(_doc(tp), raw=False)["leaves"][0]
        assert enc["dtype"] == "bf16n" and len(enc["data"]) == 2 * int(np.prod(enc["shape"]))


def test_legacy_bf16_tag_and_flagless_zstd_frame_load(tmp_path):
    vals = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    bf = jnp.asarray(vals, jnp.bfloat16)
    doc = msgpack.packb({
        "tree": {"t": "d", "v": {"x": {"t": "__leaf__", "v": 0}}},
        "leaves": [{"dtype": "bf16", "data": np.asarray(bf, np.float32).tobytes(),
                    "shape": [3, 4]}],
        "meta": {"m": 1},
    }, use_bin_type=True)
    p = str(tmp_path / "legacy")
    with open(p, "wb") as f:  # no flag byte: a raw zstd frame
        f.write(zstandard.ZstdCompressor(level=3).compress(doc))
    got, meta = tck.load_checkpoint(p, device="cpu")
    want, _ = jck.load_checkpoint(p)
    assert meta == {"m": 1}
    assert got["x"].dtype == torch.bfloat16
    assert _bits(got["x"]) == _bits(want["x"])


def test_unknown_codec_flag_raises(tmp_path):
    p = str(tmp_path / "bad")
    with open(p, "wb") as f:
        f.write(b"Q" + zlib.compress(b"\x80"))
    with pytest.raises(ValueError, match="codec flag"):
        tck.load_checkpoint(p, device="cpu")


def test_none_leaf_raises_as_in_the_reference(tmp_path):
    with pytest.raises(TypeError):
        jck.save_checkpoint(str(tmp_path / "j"), {"a": jnp.ones(2), "b": None})
    with pytest.raises(TypeError):
        tck.save_checkpoint(str(tmp_path / "t"), {"a": torch.ones(2), "b": None})


def test_64_bit_leaves_keep_their_dtype_in_the_port(tmp_path):
    """The port keeps a stored int64/float64 leaf; the reference's load
    narrows it to 32 bits (``jnp.asarray`` with x64 off)."""
    p = str(tmp_path / "wide")
    tree = {"i": np.arange(-3, 3, dtype=np.int64) * (2**40), "f": np.array([1 / 3], np.float64),
            "n": 7, "x": 2.5}
    jck.save_checkpoint(p, tree)
    got, _ = tck.load_checkpoint(p, device="cpu")
    assert got["i"].dtype == torch.int64 and got["f"].dtype == torch.float64
    assert got["n"].dtype == torch.int64 and got["x"].dtype == torch.float64
    np.testing.assert_array_equal(got["i"].numpy(), tree["i"])
    assert got["f"].item() == 1 / 3
    want, _ = jck.load_checkpoint(p)
    assert want["i"].dtype == jnp.int32 and want["f"].dtype == jnp.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_msgpack_subset_equals_msgpack(dtype):
    jtree, ttree = _trees(dtype, seed=3)
    structure, leaves = tck._pack_tree(ttree)
    doc = {"tree": structure, "leaves": leaves, "meta": META}
    want = msgpack.packb(doc, use_bin_type=True)
    assert _msgpack.packb(doc) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128,
    -129, -32768, -32769, -2**31, -2**31 - 1, -2**63, 1.5, -0.0, True, False, None, "",
    "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 40000, b"", b"x" * 255, b"x" * 256,
    b"x" * 70000, [], [1] * 15, [1] * 16, [1] * 70000, {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {str(i): i for i in range(70000)},
], ids=lambda v: f"{type(v).__name__}{len(v) if hasattr(v, '__len__') else v}")
def test_msgpack_subset_every_format_boundary(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("data", [
    msgpack.packb(msgpack.ExtType(1, b"ab")), b"\xc1", b"\x92\x01", b"\x01\x02",
    b"\xc4\x05ab",
], ids=["ext", "reserved", "truncated-array", "extra-data", "truncated-bin"])
def test_msgpack_subset_rejects_other_formats(data):
    with pytest.raises(ValueError):
        _msgpack.unpackb(data)


def test_roundtrip_without_msgpack_or_zstandard(tmp_path, monkeypatch):
    """With both optional wheels blocked the port writes zlib and reads it
    back; a zstd file raises the reference's RuntimeError."""
    zp = str(tmp_path / "z.ckpt")
    jtree, ttree = _trees("bfloat16", seed=5)
    tck.save_checkpoint(zp, ttree, meta=META)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    monkeypatch.setitem(sys.modules, "zstandard", None)
    blocked = importlib.reload(tck)
    try:
        assert blocked.zstandard is None
        p = str(tmp_path / "plain.ckpt")
        blocked.save_checkpoint(p, ttree, meta=META)
        with open(p, "rb") as f:
            assert f.read(1) == b"z"
        got, meta = blocked.load_checkpoint(p, device="cpu")
        assert meta == META
        for a, b in zip(tree_flatten(got)[0], tree_flatten(ttree)[0]):
            assert _bits(a) == _bits(b)
        with pytest.raises(RuntimeError, match="zstandard"):
            blocked.load_checkpoint(zp, device="cpu")
    finally:
        monkeypatch.undo()
        importlib.reload(tck)
    # the zlib file is the reference's format too
    got_j, _ = jck.load_checkpoint(p)
    _same_tree(got_j, ttree)


def test_manager_keeps_the_latest(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, {"x": torch.tensor([s], dtype=torch.int32)})
    assert mgr.latest_step() == 30
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000020.msgpack.zst",
                                            "ckpt_00000030.msgpack.zst"]
    got, meta = mgr.restore_latest(device="cpu")
    assert int(got["x"][0]) == 30 and meta["step"] == 30
    jgot, jmeta = jck.CheckpointManager(str(tmp_path), keep=2).restore_latest()
    assert int(jgot["x"][0]) == 30 and jmeta["step"] == 30
    assert tck.CheckpointManager(str(tmp_path / "empty")).restore_latest() == (None, None)


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_arena_files_cross_both_ways(tmp_path, storage):
    rng = np.random.RandomState(2)
    vec = rng.randn(300, 256).astype(np.float32)
    ja, ta = JArena(256, storage=storage), TArena(256, storage=storage)
    ja.add_batch(vec)
    ta.add_batch(vec)
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    ja.save(jp, meta={"who": "j"})
    ta.save(tp, meta={"who": "j"})
    assert _doc(jp) == _doc(tp)
    t_from_j, extra = TArena.load(jp)
    j_from_t, _ = JArena.load(tp)
    assert extra == {"who": "j"}
    for a, b in ((t_from_j, ja), (j_from_t, ta)):
        assert (len(a), a.dim, a.storage, a.qblock) == (len(b), b.dim, b.storage, b.qblock)
        np.testing.assert_array_equal(a.raw()[0][: len(a)], b.raw()[0][: len(b)])
        if storage == "int8":
            np.testing.assert_array_equal(a.raw()[1][: len(a)], b.raw()[1][: len(b)])
    tck.save_checkpoint(str(tmp_path / "x"), {"a": torch.ones(1)}, meta={"kind": "x"})
    with pytest.raises(ValueError, match="not an arena"):
        TArena.load(str(tmp_path / "x"))


def _dbs(storage):
    jdb, tdb = JDB(), TDB(device="cpu")
    if storage != "f32":
        jdb.arena = JArena(256, storage=storage)
        jdb.engine = JEngine(jdb.arena, use_kernel=False)
        tdb.arena = TArena(256, storage=storage)
        tdb.engine = TEngine(tdb.arena, device="cpu")
    return jdb, tdb


def _answers(db, q, k):
    hits = db.query(q, k)
    return [s for s, _ in hits], [(rec.features, rec.payload) for _, rec in hits]


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_feedback_db_files_cross_and_restored_queries_agree(tmp_path, storage):
    jdb, tdb = _dbs(storage)
    for i in range(40):
        feats = {"loc_bedroom": 1.0, f"u{i}": 0.3}
        for db in (jdb, tdb):
            db.add_feedback(feats, [4, 8, 16][i % 3], i / 40.0, {"latency": 0.1 * i})
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    jdb.save(jp)
    tdb.save(tp)
    assert _doc(jp) == _doc(tp)
    t_fresh, j_fresh = _dbs(storage)[1], _dbs(storage)[0]
    t_fresh.restore(jp)
    j_fresh.restore(tp)
    assert len(t_fresh) == len(j_fresh) == 40
    assert t_fresh.engine.device == torch.device("cpu")
    for q in ({"loc_bedroom": 1.0}, {"u3": 1.0, "loc_bedroom": 0.5}):
        # each package's restored store answers as its saved one, scores
        # bit for bit; across packages the records agree exactly and the
        # scores (two GEMMs) within the retrieval tests' 1e-6
        assert _answers(t_fresh, q, 6) == _answers(tdb, q, 6)
        assert _answers(j_fresh, q, 6) == _answers(jdb, q, 6)
        ts, trec = _answers(t_fresh, q, 6)
        js, jrec = _answers(jdb, q, 6)
        assert trec == jrec
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    # writeback after a restore stays append-only and queryable
    t_fresh.add_feedback({"loc_kitchen": 1.0}, 4, 0.9, {})
    assert len(t_fresh) == 41
    assert t_fresh.query({"loc_kitchen": 1.0}, 1)[0][1].payload["bits"] == 4
    with pytest.raises(ValueError):
        TDB(storage="int8" if storage == "f32" else "f32", device="cpu").restore(tp)
