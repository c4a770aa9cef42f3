"""Synthetic LM token pipeline (the JAX package's ``data/lm.py``, a copy:
plain numpy, so the token stream is the reference's bit for bit).

An order-1 Markov chain over the vocabulary generates streams with
learnable structure, plus an infinite batch iterator of host arrays (the
caller moves them to the device).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class MarkovTokens:
    """Order-1 Markov token source with a sparse, seeded transition graph."""

    def __init__(self, vocab_size: int, branching: int = 8, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.vocab = vocab_size
        self.next_ids = rng.randint(0, vocab_size,
                                    size=(vocab_size, branching)).astype(np.int32)
        probs = rng.dirichlet(np.ones(branching) * 0.6, size=vocab_size)
        self.probs = probs.astype(np.float64)

    def sample(self, rng: np.random.RandomState, batch: int,
               seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len), np.int32)
        cur = rng.randint(0, self.vocab, size=batch)
        for t in range(seq_len):
            out[:, t] = cur
            choice = np.array([
                rng.choice(self.next_ids[c], p=self.probs[c]) for c in cur
            ])
            cur = choice
        return out


def token_batches(vocab_size: int, batch: int, seq_len: int, *,
                  seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    src = MarkovTokens(vocab_size, seed=seed)
    rng = np.random.RandomState(seed + 1)
    while True:
        yield {"tokens": src.sample(rng, batch, seq_len)}
