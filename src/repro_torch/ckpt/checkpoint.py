"""Tree checkpointing: the JAX package's file format, read and written with
PyTorch (the counterpart of its ``ckpt/checkpoint.py``).

Format: a 1-byte codec flag followed by a compressed msgpack document
    {"tree": <structure with leaf placeholders>,
     "leaves": [{"dtype", "data", "shape"}...],
     "meta": {...user metadata...}}

The flag selects the codec: ``Z`` = zstandard, ``z`` = zlib.
``zstandard`` is optional: without it the writer falls back to zlib, and
a zstd file raises. Legacy flag-less files (raw zstd frames, magic
``0x28 B5 2F FD``) are still read. The document is encoded by this
package's own msgpack subset (``ckpt/_msgpack.py``), byte for byte what
``msgpack.packb(doc, use_bin_type=True)`` gives, so ``msgpack`` is not
needed.

Files cross between both packages: leaves are numbered in
``jax.tree.flatten``'s order (``core/tree.py``: dict keys sorted), a
leaf's tag is its numpy ``dtype.str``, and bf16 is stored natively as
its uint16 bit pattern under ``bf16n`` (the legacy ``bf16`` tag, f32
bytes, still loads). A leaf may be a tensor, a numpy array or a Python
scalar (numpy's conversion: int -> int64, float -> float64); a ``None``
leaf raises ``TypeError``, as in the reference.

Loading keeps each leaf's stored dtype, int64 and float64 included. The
reference's load goes through ``jnp.asarray``, which narrows 64-bit
leaves to 32 bits while JAX's x64 mode is off; the port does not.
"""

from __future__ import annotations

import os
import tempfile
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt import _msgpack
from repro_torch.core.tree import tree_flatten
from repro_torch.device import resolve_device

try:
    import zstandard
except ImportError:  # optional wheel; zlib fallback below
    zstandard = None

Tree = Any

_LEAF = "__leaf__"

_FLAG_ZSTD = b"Z"
_FLAG_ZLIB = b"z"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"  # legacy flag-less files


def _compress(doc: bytes, level: int) -> bytes:
    if zstandard is not None:
        return _FLAG_ZSTD + zstandard.ZstdCompressor(level=level).compress(doc)
    # zstd levels go to 22, zlib's cap is 9: clamp rather than reject
    return _FLAG_ZLIB + zlib.compress(doc, min(level, 9))


def _decompress(blob: bytes) -> bytes:
    flag, payload = blob[:1], blob[1:]
    if flag == _FLAG_ZLIB:
        return zlib.decompress(payload)
    if flag == _FLAG_ZSTD or blob[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstandard, which is not "
                "installed; pip install zstandard to read it"
            )
        data = payload if flag == _FLAG_ZSTD else blob
        return zstandard.ZstdDecompressor().decompress(data)
    raise ValueError(f"unrecognised checkpoint codec flag {flag!r}")


def _encode_leaf(leaf) -> Dict[str, Any]:
    if leaf is None:
        raise TypeError("a checkpoint leaf may not be None")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            # native 2-byte storage: the 16-bit pattern IS the bf16
            arr = t.contiguous().view(torch.int16).numpy()
            return {"dtype": "bf16n", "data": arr.tobytes(), "shape": list(arr.shape)}
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return {"dtype": arr.dtype.str, "data": arr.tobytes(), "shape": list(arr.shape)}


def _pack_tree(tree: Tree):
    leaves, structure = tree_flatten(tree)
    counter = iter(range(len(leaves)))

    def encode_structure(s):
        if s is None:
            return {"t": _LEAF, "v": next(counter)}
        kind, keys, children = s
        if kind == "dict":
            return {"t": "d", "v": {k: encode_structure(c) for k, c in zip(keys, children)}}
        return {"t": "l" if kind == "list" else "t", "v": [encode_structure(c) for c in children]}

    return encode_structure(structure), [_encode_leaf(leaf) for leaf in leaves]


def _decode_leaf(enc: Dict[str, Any], device: torch.device) -> torch.Tensor:
    shape = [int(d) for d in enc["shape"]]
    if enc["dtype"] == "bf16n":
        arr = np.frombuffer(enc["data"], np.int16).reshape(shape)
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    elif enc["dtype"] == "bf16":  # legacy: bf16 widened to f32 bytes
        arr = np.frombuffer(enc["data"], np.float32).reshape(shape)
        t = torch.from_numpy(arr.copy()).to(torch.bfloat16)
    else:
        arr = np.frombuffer(enc["data"], np.dtype(enc["dtype"])).reshape(shape)
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def _unpack_tree(structure, leaves, device: torch.device) -> Tree:
    def decode(node):
        t = node["t"]
        if t == "d":
            return {k: decode(v) for k, v in node["v"].items()}
        if t in ("l", "t"):
            seq = [decode(v) for v in node["v"]]
            return seq if t == "l" else tuple(seq)
        return _decode_leaf(leaves[node["v"]], device)

    return decode(structure)


def save_checkpoint(
    path: str,
    tree: Tree,
    meta: Optional[Dict[str, Any]] = None,
    level: int = 3,
) -> None:
    structure, leaves = _pack_tree(tree)
    doc = _msgpack.packb({"tree": structure, "leaves": leaves, "meta": meta or {}})
    comp = _compress(doc, level)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # atomic write
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(comp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_checkpoint(path: str, device=None):
    """Returns (tree, meta): tensor leaves on ``device`` (None: the CUDA
    card, through ``resolve_device``), each in its stored dtype."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        doc = _msgpack.unpackb(_decompress(f.read()))
    return _unpack_tree(doc["tree"], doc["leaves"], dev), doc["meta"]


class CheckpointManager:
    """Rolling checkpoints: keep the latest ``keep`` files per run dir."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.msgpack.zst")

    def save(self, step: int, tree: Tree, meta: Optional[Dict] = None):
        save_checkpoint(self.path(step), tree, dict(meta or {}, step=step))
        self._gc()

    def latest_step(self) -> Optional[int]:
        steps = sorted(self._steps())
        return steps[-1] if steps else None

    def restore_latest(self, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return load_checkpoint(self.path(step), device)

    def _steps(self):
        out = []
        for f in os.listdir(self.directory):
            if f.startswith("ckpt_") and f.endswith(".msgpack.zst"):
                out.append(int(f[5:13]))
        return out

    def _gc(self):
        steps = sorted(self._steps())
        for s in steps[: -self.keep]:
            os.unlink(self.path(s))
