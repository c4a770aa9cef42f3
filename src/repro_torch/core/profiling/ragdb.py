"""RAG knowledge databases (the paper's §III-B2).

Two stores, both built on a feature-hashed vector index with cosine
retrieval (an embedding-model-backed store is a drop-in — the interface
is add/query):

- ``ContextQuantFeedbackDB``: archives (context features, assigned bits,
  realised feedback/satisfaction) per round — "semantic mappings between
  contextual factors and user factors".
- ``HardwareQuantPerfDB``: archives (hardware features, bits) ->
  measured (accuracy, energy, latency) — the quantization-performance
  trade-off store queried by hardware similarity.

Records append continuously ("facilitating continuous refinement").

Both databases ride the retrieval subsystem
(``repro_torch.retrieval``, DESIGN.md §10): vectors live in a contiguous
arena slab and queries go through the batched engine — one call per
cohort (``query_batch``) instead of one numpy scan per client. The
neighbour-weighting estimators are exposed as ``*_from_hits`` functions
so the cohort-batched planner can score pre-fetched hit lists. The
legacy brute-force ``VectorStore`` stays as the arena's equivalence
oracle (same tie contract: descending similarity, ties by ascending
record index).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.retrieval.store import ArenaVectorStore

EMBED_DIM = 256

# neighbours fetched per store per query — the estimators' k = 8 times
# the 4x over-fetch the bit-distance weighting wants
RETRIEVE_K = 32


def _hash_idx(token: str) -> Tuple[int, float]:
    h = hashlib.blake2b(token.encode(), digest_size=8).digest()
    idx = int.from_bytes(h[:4], "little") % EMBED_DIM
    sign = 1.0 if h[4] & 1 else -1.0
    return idx, sign


def embed_features(features: Dict[str, float]) -> np.ndarray:
    """Feature-hash a {name: weight} dict into a unit vector."""
    v = np.zeros(EMBED_DIM, np.float32)
    for name, w in features.items():
        idx, sign = _hash_idx(name)
        v[idx] += sign * float(w)
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def embed_batch(features_list: Iterable[Dict[str, float]]) -> np.ndarray:
    """Embed a whole cohort's feature dicts into one (K, D) query batch."""
    return np.stack([embed_features(f) for f in features_list])


@dataclasses.dataclass
class Record:
    features: Dict[str, float]
    payload: Dict[str, Any]


class VectorStore:
    """Legacy brute-force store — the arena engine's equivalence oracle.

    Kept deliberately simple (one numpy scan per query) but with the two
    seed defects fixed: adds write into an amortized-doubling matrix
    instead of re-stacking O(N) vectors on every add -> query cycle, and
    a zero-norm query (empty/cancelled features) returns no hits instead
    of cosine-against-zeros.
    """

    def __init__(self):
        self._matrix = np.zeros((64, EMBED_DIM), np.float32)
        self._n = 0
        self._records: List[Record] = []

    def __len__(self) -> int:
        return self._n

    def add(self, features: Dict[str, float], payload: Dict[str, Any]) -> None:
        if self._n == self._matrix.shape[0]:
            grown = np.zeros((2 * self._n, EMBED_DIM), np.float32)
            grown[: self._n] = self._matrix
            self._matrix = grown
        self._matrix[self._n] = embed_features(features)
        self._records.append(Record(features, payload))
        self._n += 1

    def query(
        self, features: Dict[str, float], k: int = 8
    ) -> List[Tuple[float, Record]]:
        if not self._records:
            return []
        q = embed_features(features)
        if not np.any(q):  # zero-norm query guard
            return []
        sims = self._matrix[: self._n] @ q
        # independent of the engine's stable_topk on purpose — this is
        # the oracle, so it uses the plain brute-force specification of
        # the tie contract (stable sort: desc score, ties by asc index)
        idx = np.argsort(-sims, kind="stable")[: min(k, self._n)]
        return [(float(sims[i]), self._records[i]) for i in idx]


# ---------------------------------------------------------------------------
# neighbour-weighted estimators over hit lists
# ---------------------------------------------------------------------------


def satisfaction_from_hits(
    hits: List[Tuple[float, Record]], bits: int
) -> Optional[Tuple[float, float]]:
    """(estimate, confidence) for assigning ``bits`` given retrieved
    context hits.

    Retrieval is context-wide; matching-bit neighbours weigh fully,
    near-bit neighbours partially (quantization effects are smooth in
    log-bits).
    """
    if not hits:
        return None
    num = den = 0.0
    log_bits = math.log2(bits)
    for sim, rec in hits:
        if sim <= 0:
            continue
        # math.log2 over np.log2: these are python scalars in the
        # planner's per-level hot loop, where numpy scalar dispatch
        # dominated the profile
        db = abs(math.log2(rec.payload["bits"]) - log_bits)
        bit_w = max(0.0, 1.0 - 0.5 * db)
        w = sim * bit_w
        num += w * rec.payload["satisfaction"]
        den += w
    if den < 1e-6:
        return None
    conf = min(1.0, den / 3.0)
    return num / den, conf


def perf_from_hits(
    hits: List[Tuple[float, Record]], bits: int
) -> Optional[Dict[str, float]]:
    """Similarity-weighted perf estimate from matching-bit hits."""
    agg: Dict[str, float] = {}
    den = 0.0
    for sim, rec in hits:
        if sim <= 0 or rec.payload["bits"] != bits:
            continue
        for name, val in rec.payload["perf"].items():
            agg[name] = agg.get(name, 0.0) + sim * val
        den += sim
    if den < 1e-6:
        return None
    return {name: v / den for name, v in agg.items()}


# ---------------------------------------------------------------------------
# the arena-backed stores
# ---------------------------------------------------------------------------


class _FeatureArenaStore(ArenaVectorStore):
    """Feature-dict front end over the arena store (append-only; save /
    restore serialize the Record list through the ckpt layer)."""

    def __init__(self, *, storage: str = "f32", device=None):
        super().__init__(
            EMBED_DIM,
            storage=storage,
            device=device,
            to_doc=dataclasses.asdict,
            from_doc=lambda d: Record(**d),
        )

    def add(self, features: Dict[str, float], payload: Dict[str, Any]) -> None:
        self.add_vec(embed_features(features), Record(features, payload))

    def query(
        self, features: Dict[str, float], k: int = 8
    ) -> List[Tuple[float, Record]]:
        q = embed_features(features)
        if not len(self) or not np.any(q):  # zero-norm query guard
            return []
        return self.query_vec(q, k)


class ContextQuantFeedbackDB(_FeatureArenaStore):
    """context/preference features + bits -> realised satisfaction feedback."""

    def add_feedback(
        self,
        features: Dict[str, float],
        bits: int,
        satisfaction: float,
        perf: Dict[str, float],
    ) -> None:
        self.add(
            features,
            {"bits": bits, "satisfaction": satisfaction, "perf": dict(perf)},
        )

    def estimate_satisfaction(
        self, features: Dict[str, float], bits: int, k: int = 8
    ) -> Optional[Tuple[float, float]]:
        return satisfaction_from_hits(self.query(features, k=k * 4), bits)


class HardwareQuantPerfDB(_FeatureArenaStore):
    """hardware features + bits -> measured perf dict."""

    def add_measurement(
        self, hw_features: Dict[str, float], bits: int, perf: Dict[str, float]
    ) -> None:
        self.add(hw_features, {"bits": bits, "perf": dict(perf)})

    def estimate_perf(
        self, hw_features: Dict[str, float], bits: int, k: int = 8
    ) -> Optional[Dict[str, float]]:
        return perf_from_hits(self.query(hw_features, k=k * 4), bits)
