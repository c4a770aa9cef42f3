"""Arena-backed vector store with per-record payloads.

The record layer the RAG databases (``core/profiling/ragdb.py``) ride:
vectors live in one ``ArenaStore`` slab (f32 or the int8 blockwise
storage class), payload records in a parallel python list, and every
query goes through the batched ``RetrievalEngine`` — one engine call per
cohort instead of one numpy scan per client.

The store is strictly append-only: feedback writeback only ever appends
(vector, record) pairs, so record indices are stable for the lifetime of
the store and a reload resumes appending where the save left off.
Persistence rides the arena's checkpoint format with records serialized
into the metadata document via the ``to_doc``/``from_doc`` codec hooks.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from repro_torch.retrieval.arena import ArenaStore
from repro_torch.retrieval.engine import RetrievalEngine

Hit = Tuple[float, Any]  # (similarity, record)


class ArenaVectorStore:
    """Vectors in an arena + opaque payload records, batched top-k."""

    def __init__(
        self,
        dim: int,
        *,
        storage: str = "f32",
        qblock: int = 64,
        use_kernel: Optional[bool] = None,
        device=None,
        to_doc: Optional[Callable[[Any], Any]] = None,
        from_doc: Optional[Callable[[Any], Any]] = None,
    ):
        self.arena = ArenaStore(dim, storage=storage, qblock=qblock)
        self.engine = RetrievalEngine(self.arena, use_kernel=use_kernel, device=device)
        self.records: List[Any] = []
        self._to_doc = to_doc or (lambda r: r)
        self._from_doc = from_doc or (lambda d: d)

    def __len__(self) -> int:
        return len(self.records)

    def add_vec(self, vec: np.ndarray, record: Any) -> int:
        """Append one (vector, record) pair; returns the record index."""
        idx = self.arena.add(vec)
        self.records.append(record)
        return idx

    def query_vec(self, vec: np.ndarray, k: int = 8) -> List[Hit]:
        """Top-k hits for one query vector."""
        return self.query_batch(np.asarray(vec, np.float32)[None], k)[0]

    def query_batch(self, queries: np.ndarray, k: int = 8) -> List[List[Hit]]:
        """One engine call for a (Q, D) query batch -> per-query hit
        lists, each ordered by the engine's tie contract."""
        scores, idx = self.engine.topk(queries, k)
        return [
            [(float(s), self.records[j]) for s, j in zip(srow, irow)]
            for srow, irow in zip(scores, idx)
        ]

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        self.arena.save(path, meta={"records": [self._to_doc(r) for r in self.records]})

    def restore(self, path: str) -> None:
        """Replace this store's contents from a ``save`` checkpoint (the
        codec hooks and the engine's kernel preference and device of this
        instance are kept)."""
        arena, extra = ArenaStore.load(path)
        if arena.dim != self.arena.dim or arena.storage != self.arena.storage:
            raise ValueError(
                f"checkpoint is ({arena.dim}, {arena.storage}), store is "
                f"({self.arena.dim}, {self.arena.storage})"
            )
        self.arena = arena
        self.engine = RetrievalEngine(arena, use_kernel=self.engine.use_kernel,
                                      device=self.engine.device)
        self.records = [self._from_doc(d) for d in extra["records"]]
