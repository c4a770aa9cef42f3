"""Batched top-k retrieval over an ``ArenaStore`` (the JAX package's
``retrieval/engine.py``, single-device path).

One selection contract everywhere: descending score, equal scores by
ascending record index. Every query goes through
``kernels.topk_similarity.topk_cosine`` on the engine's device: the CUDA
kernel on a card, its plain PyTorch version on the CPU. The capacity
slab is uploaded once per (buffer identity, live count) and kept on the
device between appends.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.kernels.topk_similarity import MAX_K, topk_cosine
from repro_torch.retrieval.arena import ArenaStore


class RetrievalEngine:
    """Batched cosine top-k queries against one arena."""

    def __init__(self, store: ArenaStore, *, device=None):
        self.store = store
        self.device = resolve_device(device)
        # device copy of the capacity slab, keyed on (buffer identity,
        # live count): appends and grows invalidate it
        self._dev_cache = None

    def _slab(self):
        data, scales = self.store.raw()
        n = len(self.store)
        cache = self._dev_cache
        if cache is None or cache[0] is not data or cache[1] != n:
            cache = (
                data,
                n,
                torch.from_numpy(data).to(self.device),
                None if scales is None else torch.from_numpy(scales).to(self.device),
            )
            self._dev_cache = cache
        return cache[2], cache[3]

    def topk(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) query batch -> (scores (Q, k'), idx (Q, k')) with
        k' = min(k, len(store)); empty stores return zero-width arrays."""
        queries = np.ascontiguousarray(np.asarray(queries, np.float32))
        if queries.ndim != 2 or queries.shape[1] != self.store.dim:
            raise ValueError(f"expected (Q, {self.store.dim}), got {queries.shape}")
        q = queries.shape[0]
        n = len(self.store)
        k = min(k, n)
        if n == 0 or k <= 0 or q == 0:
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int32)
        if k > MAX_K:
            raise ValueError(f"k = {k} exceeds the kernel's limit of {MAX_K}")
        with obs.span("retrieval.query", q=q, k=k, rows=n):
            obs.metrics.inc("retrieval.queries", q)
            obs.metrics.inc("retrieval.query_rows", q * n)
            data, scales = self._slab()
            qm = torch.from_numpy(queries).to(self.device)
            s, i = topk_cosine(qm, data, scales, n, k=k)
            return s.cpu().numpy(), i.cpu().numpy()
