"""Batched top-k retrieval over an ``ArenaStore`` (the JAX package's
``retrieval/engine.py``).

One selection contract everywhere: descending score, equal scores by
ascending record index. A query with k up to the kernel's ``MAX_K`` goes
through ``kernels.topk_similarity.topk_cosine`` on the engine's device:
the CUDA kernel on a card, its plain PyTorch version on the CPU, and the
plain version on any device with ``use_kernel=False`` (the reference's
keyword; True and None dispatch by device). The
capacity slab is uploaded once per (buffer identity, live count) and kept
on the device between appends. A larger k takes the reference's host path
(``_topk_numpy``): one GEMM over the live slab in numpy (int8 stores in
chunks of ``CHUNK_ROWS`` rows, merged exactly) and ``stable_topk``; the
numpy helpers below are the reference's, so the same numpy on the same
host gives the same indices and scores bit for bit.

The sharded paths (DESIGN.md §15): with ``mesh`` (``launch.mesh.DataMesh``)
the capacity slab's rows split over the mesh's shards, each kept on its
device, and a query with k <= ``kernels.ops.TOPK_LANES`` runs
``ops.topk_cosine_sharded``, bit for bit the unsharded top-k. ``n_shards`` >
1 instead shards the host path over ``ArenaStore.shard_bounds`` and merges
exactly (``_topk_numpy_sharded``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import TOPK_LANES, topk_cosine_sharded
from repro_torch.kernels.topk_similarity import MAX_K, topk_cosine, topk_plain
from repro_torch.retrieval.arena import ArenaStore

# int8 stores dequantize in row chunks of this size on the numpy path so
# a large arena never materialises its full f32 slab
CHUNK_ROWS = 1 << 15


def stable_topk(scores: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact (Q, k) top-k of a (Q, N) score matrix under the tie contract:
    the kth-largest value from ``np.partition``, then the candidates at or
    above it stable-sorted by (-score, index)."""
    q, n = scores.shape
    k = min(k, n)
    if k == n:
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    else:
        thresh = np.partition(scores, n - k, axis=1)[:, n - k]
        order = np.empty((q, k), np.int64)
        for r in range(q):
            row = scores[r]
            cand = np.nonzero(row >= thresh[r])[0]
            order[r] = cand[np.lexsort((cand, -row[cand]))][:k]
    return np.take_along_axis(scores, order, axis=1), order.astype(np.int32)


def brute_force_topk(
    vectors: np.ndarray, queries: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The specification: full scores, full stable argsort, slice k."""
    scores = queries @ vectors.T
    k = min(k, vectors.shape[0])
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, order, axis=1), order.astype(np.int32)


def merge_candidates(cand_s, cand_i, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-way merge of per-chunk top-k candidate lists under the tie
    contract: any global top-k member is top-k within its chunk, so
    re-sorting the concatenated candidates by (-score, ascending global
    index) reproduces the global selection."""
    s_all = np.concatenate(cand_s, axis=1)
    i_all = np.concatenate(cand_i, axis=1)
    q = s_all.shape[0]
    k = min(k, s_all.shape[1])
    scores = np.empty((q, k), np.float32)
    idx = np.empty((q, k), np.int32)
    for r in range(q):
        order = np.lexsort((i_all[r], -s_all[r]))[:k]
        scores[r] = s_all[r, order]
        idx[r] = i_all[r, order]
    return scores, idx


def normalize_rows(mat: np.ndarray) -> np.ndarray:
    """Unit-normalize rows; all-zero rows stay zero."""
    mat = np.asarray(mat, np.float32)
    norms = np.linalg.norm(mat, axis=1, keepdims=True)
    return np.where(norms > 0, mat / np.maximum(norms, 1e-30), mat)


class RetrievalEngine:
    """Batched cosine top-k queries against one arena.

    The order of dispatch is the reference's: ``mesh`` and k <= TOPK_LANES
    first (the row-sharded top-k), then k <= MAX_K on the engine's device
    (the reference's kernel step), then ``n_shards`` > 1 (the host-sharded
    numpy path), then numpy. The reference reaches the kernel step only
    with ``use_kernel`` true and otherwise goes to numpy; here
    ``use_kernel=False`` runs the kernel's plain version on the device at
    that step (the port's meaning since the keyword came), so the two
    orders meet wherever the reference takes its kernel, and the host
    paths serve k > MAX_K only.
    """

    def __init__(self, store: ArenaStore, *, use_kernel: Optional[bool] = None, device=None,
                 mesh=None, n_shards: int = 0):
        self.store = store
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        self.mesh = mesh
        self.n_shards = int(n_shards)
        # device copy of the capacity slab, keyed on (buffer identity,
        # live count): appends and grows invalidate it; the mesh path's
        # per-shard copies likewise
        self._dev_cache = None
        self._shard_cache = None

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

    def _shard_slabs(self):
        """Each shard's (rows, D) slab and scale rows on its device: the
        capacity slab padded to shards x ``shard_rows`` with zero rows and
        unit scales, the arena's own padding."""
        data, scales = self.store.raw()
        n = len(self.store)
        cache = self._shard_cache
        if cache is None or cache[0] is not data or cache[1] != n:
            rows = self.store.shard_rows(len(self.mesh.devices))

            def part(a, lo, fill):
                if a is None:
                    return None
                out = a[lo : lo + rows]
                if out.shape[0] < rows:
                    out = np.concatenate(
                        [out, np.full((rows - out.shape[0], a.shape[1]), fill, a.dtype)])
                return torch.from_numpy(np.ascontiguousarray(out))

            recs, scs = [], []
            for s, dev in enumerate(self.mesh.devices):
                recs.append(part(data, s * rows, 0).to(dev))
                sc = part(scales, s * rows, 1.0)
                scs.append(None if sc is None else sc.to(dev))
            cache = (data, n, recs, None if scales is None else scs)
            self._shard_cache = cache
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
        with obs.span("retrieval.query", q=q, k=k, rows=n):
            obs.metrics.inc("retrieval.queries", q)
            obs.metrics.inc("retrieval.query_rows", q * n)
            if self.mesh is not None and k <= TOPK_LANES:
                return self._topk_sharded(queries, k)
            if k <= MAX_K:
                data, scales = self._slab()
                qm = torch.from_numpy(queries).to(self.device)
                if self.use_kernel is False:
                    s, i = topk_plain(qm, data, scales, n, k)
                else:
                    s, i = topk_cosine(qm, data, scales, n, k=k)
                return s.cpu().numpy(), i.cpu().numpy()
            if self.n_shards > 1:
                return self._topk_numpy_sharded(queries, k)
            return self._topk_numpy(queries, k)

    def _topk_sharded(self, queries, k):
        """The row-sharded top-k over the mesh (``ops.topk_cosine_sharded``)."""
        recs, scales = self._shard_slabs()
        qm = torch.from_numpy(queries).to(self.mesh.devices[0])
        with obs.span("shard_merge", shards=len(self.mesh.devices), k=k):
            s, i = topk_cosine_sharded(qm, recs, scales, len(self.store), k=k, mesh=self.mesh,
                                       use_kernel=self.use_kernel is not False)
            return s.cpu().numpy(), i.cpu().numpy()

    def _topk_numpy_sharded(self, queries, k):
        """The reference's host-sharded path: one GEMM and top-k over each
        shard's rows (``ArenaStore.shard_bounds``), then the exact merge.
        BLAS may pick another microkernel for each GEMM shape, so the
        scores may differ from the one-GEMM path's in the last place."""
        store, n = self.store, len(self.store)
        cand_s, cand_i = [], []
        with obs.span("shard_merge", shards=self.n_shards, k=k):
            for lo, hi in store.shard_bounds(self.n_shards):
                hi = min(hi, n)
                if hi <= lo:
                    continue
                s, i = stable_topk(queries @ store.dequantize_rows(lo, hi).T, k)
                cand_s.append(s)
                cand_i.append(i + lo)
            return merge_candidates(cand_s, cand_i, k)

    def _topk_numpy(self, queries, k):
        """The reference's host path: past the kernel's k limit."""
        store = self.store
        n = len(store)
        if store.storage == "f32":
            return stable_topk(queries @ store.vectors().T, k)
        # int8: per-chunk candidates, then one stable merge (exact)
        cand_s, cand_i = [], []
        for lo in range(0, n, CHUNK_ROWS):
            hi = min(lo + CHUNK_ROWS, n)
            s, i = stable_topk(queries @ store.dequantize_rows(lo, hi).T, k)
            cand_s.append(s)
            cand_i.append(i + lo)
        return merge_candidates(cand_s, cand_i, k)
