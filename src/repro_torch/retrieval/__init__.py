from repro_torch.retrieval.arena import ArenaStore
from repro_torch.retrieval.engine import RetrievalEngine
from repro_torch.retrieval.store import ArenaVectorStore

__all__ = ["ArenaStore", "ArenaVectorStore", "RetrievalEngine"]
