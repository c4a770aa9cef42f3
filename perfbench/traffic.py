"""The benchmark's one traffic generator: a training job's token batches.

A traffic file (``perfbench/traffic/<mix>.json``) gives the parameters:
``batch`` rows of ``seq`` tokens a step, drawn from an order-1 Markov
chain over the configuration's vocabulary (``branching`` successors a
token, Dirichlet(``alpha``) transition weights), and the job's optimizer
(``optimizer``: AdamW's rate, warm-up, schedule length, betas, eps,
weight decay, clip norm). The chain is a frozen copy of the program's
``data/lm.py`` (``MarkovTokens``), drawn a whole column of rows at once:
``RandomState.choice(a, p=p)`` takes one uniform double and searches the
row's cumulative weights, so drawing the doubles of a column together and
searching each row gives the same tokens as the row-by-row loop.

Every seed gives the same sizes: only the token ids change.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def seeds(seed: int, n: int) -> Tuple[int, ...]:
    """``n`` 32-bit seeds derived from any whole number ``seed``."""
    return tuple(int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n))


class MarkovTokens:
    """Order-1 Markov source with a sparse, seeded transition graph."""

    def __init__(self, vocab: int, branching: int = 8, alpha: float = 0.6, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.vocab = vocab
        self.next_ids = rng.randint(0, vocab, size=(vocab, branching)).astype(np.int32)
        probs = rng.dirichlet(np.ones(branching) * alpha, size=vocab).astype(np.float64)
        cdf = probs.cumsum(axis=1)
        self.cdf = cdf / cdf[:, -1:]

    def sample(self, rng: np.random.RandomState, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int32)
        cur = rng.randint(0, self.vocab, size=batch)
        for t in range(seq):
            out[:, t] = cur
            u = rng.random_sample(batch)
            idx = (self.cdf[cur] <= u[:, None]).sum(axis=1)
            cur = self.next_ids[cur, idx]
        return out


def token_batches(vocab: int, traffic: Dict, seed: int) -> Iterator[np.ndarray]:
    """The job's batches, (batch, seq) int32 each, in order, from ``seed``."""
    table_seed, stream_seed = seeds(seed, 2)
    src = MarkovTokens(vocab, traffic.get("branching", 8), traffic.get("alpha", 0.6),
                       seed=table_seed)
    rng = np.random.RandomState(stream_seed)
    while True:
        yield src.sample(rng, traffic["batch"], traffic["seq"])


def rows_all_differ(batches) -> bool:
    """Whether every row of the given batches differs from every other."""
    rows = [r.tobytes() for b in batches for r in b]
    return len(set(rows)) == len(rows)
