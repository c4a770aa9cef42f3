from repro_torch.retrieval.arena import ArenaStore
from repro_torch.retrieval.engine import (
    RetrievalEngine,
    brute_force_topk,
    normalize_rows,
    stable_topk,
)
from repro_torch.retrieval.store import ArenaVectorStore

__all__ = [
    "ArenaStore",
    "ArenaVectorStore",
    "RetrievalEngine",
    "brute_force_topk",
    "normalize_rows",
    "stable_topk",
]
