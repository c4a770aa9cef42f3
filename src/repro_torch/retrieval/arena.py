"""Growable vector arena — the storage layer of the retrieval engine (the
JAX package's ``retrieval/arena.py``).

One contiguous (capacity, D) numpy buffer with amortized-doubling
appends. Two storage classes: ``f32``, and ``int8`` — int8 symbols plus a
(capacity, D // qblock) f32 scale grid, round-to-nearest on the shared
symmetric amax/qmax grid. Capacity stays a multiple of
``kernels.topk_similarity.TILE_N`` and padding rows stay exact zeros
(scales 1.0), so the top-k kernel consumes the raw capacity slab with
the live count beside it. ``shard_rows``/``shard_bounds``/``shard_nbytes``
describe the row-sharded slab of the mesh retrieval path (DESIGN.md §15).
``save``/``load`` write and read the
reference's ``arena_store`` checkpoint (``ckpt/checkpoint.py``), so an
arena crosses between both packages.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.quant import qrange
from repro_torch.kernels.topk_similarity import TILE_N

STORAGE_CLASSES = ("f32", "int8")


def _round_capacity(n: int) -> int:
    cap = TILE_N
    while cap < n:
        cap *= 2
    return cap


class ArenaStore:
    """Append-only growable (capacity, D) vector arena."""

    def __init__(
        self,
        dim: int,
        *,
        storage: str = "f32",
        qblock: int = 64,
        capacity: int = 1024,
    ):
        if storage not in STORAGE_CLASSES:
            raise ValueError(f"unknown storage class {storage!r}")
        if storage == "int8" and dim % qblock:
            raise ValueError(f"qblock {qblock} must divide dim {dim}")
        self.dim = dim
        self.storage = storage
        self.qblock = qblock if storage == "int8" else 0
        self._n = 0
        cap = _round_capacity(capacity)
        if storage == "int8":
            self._data = np.zeros((cap, dim), np.int8)
            self._scales = np.ones((cap, dim // qblock), np.float32)
        else:
            self._data = np.zeros((cap, dim), np.float32)
            self._scales = None

    def __len__(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return self._data.shape[0]

    @property
    def nbytes(self) -> int:
        out = self._data[: self._n].nbytes
        if self._scales is not None:
            out += self._scales[: self._n].nbytes
        return out

    def shard_rows(self, n_shards: int) -> int:
        """Rows a shard under row sharding: the capacity over ``n_shards``
        contiguous blocks, rounded up to a multiple of TILE_N (the mesh
        path pads the slab to ``n_shards * shard_rows`` with zero rows and
        unit scales, so shard bounds fall on the kernel's tiles)."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        return -(-self.capacity // (n_shards * TILE_N)) * TILE_N

    def shard_bounds(self, n_shards: int) -> Tuple[Tuple[int, int], ...]:
        """Each shard's ``[lo, hi)`` rows of the capacity slab: contiguous,
        TILE_N-aligned, clamped to the capacity (trailing shards may be
        empty)."""
        rows = self.shard_rows(n_shards)
        return tuple(
            (min(s * rows, self.capacity), min((s + 1) * rows, self.capacity))
            for s in range(n_shards)
        )

    def shard_nbytes(self, n_shards: int) -> int:
        """Bytes of one shard's slab (symbols and scale grid) under row
        sharding: what each device of the mesh path holds."""
        per_row = self._data.itemsize * self._data.shape[1]
        if self._scales is not None:
            per_row += self._scales.itemsize * self._scales.shape[1]
        return self.shard_rows(n_shards) * per_row

    def _grow(self, need: int) -> None:
        cap = self.capacity
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        data = np.zeros((cap, self.dim), self._data.dtype)
        data[: self._n] = self._data[: self._n]
        self._data = data
        if self._scales is not None:
            scales = np.ones((cap, self._scales.shape[1]), np.float32)
            scales[: self._n] = self._scales[: self._n]
            self._scales = scales

    def _quantize(self, mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Blockwise symmetric int8 round-to-nearest."""
        qmax = float(qrange(8))
        b, nb = mat.shape[0], self.dim // self.qblock
        blocks = mat.reshape(b, nb, self.qblock)
        amax = np.abs(blocks).max(axis=2)
        scales = (np.maximum(amax, 1e-12) / qmax).astype(np.float32)
        q = np.clip(np.rint(blocks / scales[..., None]), -qmax, qmax)
        return q.astype(np.int8).reshape(b, self.dim), scales

    def add(self, vec: np.ndarray) -> int:
        """Append one (D,) vector; returns its record index."""
        return int(self.add_batch(np.asarray(vec, np.float32)[None])[0])

    def add_batch(self, mat: np.ndarray) -> np.ndarray:
        """Append a (B, D) batch; returns the (B,) record indices."""
        mat = np.asarray(mat, np.float32)
        if mat.ndim != 2 or mat.shape[1] != self.dim:
            raise ValueError(f"expected (B, {self.dim}), got {mat.shape}")
        b = mat.shape[0]
        self._grow(self._n + b)
        lo = self._n
        if self.storage == "int8":
            q, scales = self._quantize(mat)
            self._data[lo : lo + b] = q
            self._scales[lo : lo + b] = scales
        else:
            self._data[lo : lo + b] = mat
        self._n += b
        return np.arange(lo, lo + b, dtype=np.int32)

    def dequantize_rows(self, lo: int, hi: int) -> np.ndarray:
        if self.storage == "f32":
            return self._data[lo:hi]
        q = self._data[lo:hi].astype(np.float32)
        return q * np.repeat(self._scales[lo:hi], self.qblock, axis=1)

    def vectors(self) -> np.ndarray:
        """The live (n, D) f32 slab (dequantized for int8 storage)."""
        return self.dequantize_rows(0, self._n)

    def raw(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The full capacity buffers (data, scales-or-None) the top-k
        kernel consumes beside the live count ``len(self)``."""
        return self._data, self._scales

    # -- persistence (ckpt layer) ------------------------------------------

    def save(self, path: str, meta: Optional[Dict[str, Any]] = None) -> None:
        tree = {"data": self._data[: self._n].copy()}
        if self._scales is not None:
            tree["scales"] = self._scales[: self._n].copy()
        save_checkpoint(
            path,
            tree,
            meta={
                "kind": "arena_store",
                "dim": self.dim,
                "storage": self.storage,
                "qblock": self.qblock,
                "n": self._n,
                "extra": meta or {},
            },
        )

    @classmethod
    def load(cls, path: str) -> Tuple["ArenaStore", Dict[str, Any]]:
        """Returns (store, extra-meta dict passed to ``save``); the arena
        is host memory, so its leaves load on the CPU."""
        tree, meta = load_checkpoint(path, device="cpu")
        if meta.get("kind") != "arena_store":
            raise ValueError(f"{path} is not an arena checkpoint")
        store = cls(
            meta["dim"],
            storage=meta["storage"],
            qblock=meta["qblock"] or 64,
            capacity=max(int(meta["n"]), 1),
        )
        n = int(meta["n"])
        store._data[:n] = tree["data"].numpy()
        if store._scales is not None:
            store._scales[:n] = tree["scales"].numpy()
        store._n = n
        return store, meta["extra"]
