"""Context-Quantization Evaluation — the paper's reward-penalty model
(Eqs 1–4) plus the contribution multiplier C_q under the three server
strategies of §IV-B2.

    R_Total(q) = C_q * sum_f w_f R_f(q)          (1)
    P_Total(q) = sum_f w_f P_f(q)                 (2)
    Score(q)   = R_Total(q) - P_Total(q)          (3)
    q*         = argmax_q Score(q)                (4)

R_f / P_f come from RAG retrievals when the databases have relevant
history, falling back to the analytic precision priors
(``PrecisionLevel``) when they don't — "data-driven estimation" that
sharpens as feedback accumulates.

Retrieval is bits-agnostic, so each client needs exactly one hit list
per store per planning pass: ``evaluate_levels`` fetches them itself in
the per-client path, or scores the pre-fetched ``ctx_hits``/``hw_hits``
the cohort-batched planner hands in (one engine query for the whole
cohort, DESIGN.md §10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs import BITS_TO_LEVEL
from repro_torch.core.profiling.hardware import DeviceSpec
from repro_torch.core.profiling.interview import InferredProfile
from repro_torch.core.profiling.ragdb import (
    RETRIEVE_K,
    ContextQuantFeedbackDB,
    HardwareQuantPerfDB,
    Record,
    perf_from_hits,
    satisfaction_from_hits,
)
from repro_torch.core.profiling.users import CATEGORIES, CATEGORY_PROBS, FACTORS, eq3_score

MINORITY = {"smart_home", "personal_request"}  # from Table II
MAJORITY = {"entertainment", "general_query"}

Hits = List[Tuple[float, Record]]


def prior_perf(bits: int) -> Dict[str, float]:
    lvl = BITS_TO_LEVEL[bits]
    return {
        "accuracy": lvl.rel_accuracy,
        "energy": lvl.rel_energy,
        "latency": lvl.rel_latency,
    }


def estimate_category_mix(profile: InferredProfile) -> Dict[str, float]:
    """Inferred data distribution from contextual signals (Table I:
    task type -> data distribution) blended with the global prior."""
    prior = dict(zip(CATEGORIES, CATEGORY_PROBS))
    sig = profile.category_signal
    if not sig:
        return prior
    tot_sig = sum(sig.values())
    mix = {}
    for c in CATEGORIES:
        s = sig.get(c, 0.0)
        mix[c] = 0.4 * prior[c] + 0.6 * (s / tot_sig if tot_sig else prior[c])
    tot = sum(mix.values())
    return {c: v / tot for c, v in mix.items()}


def contribution_multiplier(
    bits: int,
    profile: InferredProfile,
    strategy: str,
    max_bits: int = 32,
) -> float:
    """C_q: how much the server values this client training at ``bits``.

    Precision quality scales contribution (higher-precision updates carry
    more usable signal); the strategy reweights clients by their inferred
    class mixture:
      - fedavg: every sample equal -> quantity only.
      - class_equal: boost clients rich in minority classes.
      - majority_centric: boost clients rich in majority classes.
    """
    mix = estimate_category_mix(profile)
    quantity = 1.0
    if profile.frequency == "high":
        quantity = 1.3
    elif profile.frequency == "low":
        quantity = 0.75
    precision_quality = (bits / max_bits) ** 0.35
    if strategy == "fedavg":
        strat_w = 1.0
    elif strategy == "class_equal":
        minority_share = sum(mix[c] for c in MINORITY)
        strat_w = 0.45 + 2.2 * minority_share
    elif strategy == "majority_centric":
        majority_share = sum(mix[c] for c in MAJORITY)
        strat_w = 0.45 + 1.7 * majority_share
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return quantity * strat_w * (0.6 + 0.8 * precision_quality)


@dataclasses.dataclass
class ScoredLevel:
    bits: int
    score: float
    reward: float
    penalty: float
    contribution: float
    source: str  # "rag" | "prior" | "blend"


def evaluate_levels(
    profile: InferredProfile,
    spec: DeviceSpec,
    cqf_db: ContextQuantFeedbackDB,
    hqp_db: HardwareQuantPerfDB,
    *,
    strategy: str = "fedavg",
    energy_priority: float = 1.0,
    ctx_hits: Optional[Hits] = None,
    hw_hits: Optional[Hits] = None,
) -> List[ScoredLevel]:
    """Score every hardware-feasible precision level via Eqs (1)–(3).

    ``energy_priority`` > 1 implements the paper's energy-savings mode
    (server scales the energy penalty for the whole federation).
    ``ctx_hits``/``hw_hits`` are optional pre-fetched retrievals (the
    cohort-batched path); absent, each store is queried once here — the
    hit lists are shared across precision levels either way.
    """
    w = profile.weights_estimate()
    if hw_hits is None:
        hw_hits = hqp_db.query(spec.features(), k=RETRIEVE_K)
    if ctx_hits is None:
        ctx_hits = cqf_db.query(profile.features(), k=RETRIEVE_K)
    out: List[ScoredLevel] = []
    for bits in spec.supported_bits:
        perf = perf_from_hits(hw_hits, bits)
        source = "rag"
        if perf is None:
            perf = prior_perf(bits)
            source = "prior"
        c_q = contribution_multiplier(bits, profile, strategy)
        # Eqs (1)-(3) via the shared reward-penalty scorer
        score = eq3_score(w, perf, contribution=c_q, energy_priority=energy_priority)
        rewards = (perf["accuracy"], 1 - perf["energy"], 1 - perf["latency"])
        reward = c_q * sum(w[f] * r for f, r in zip(FACTORS, rewards))
        penalty = reward - score
        # blend with retrieved direct satisfaction history when available
        est = satisfaction_from_hits(ctx_hits, bits)
        if est is not None:
            sat_est, conf = est
            # blend weight tuned on the ablation benchmark: 0.5*conf pulled
            # scores toward noisy neighbours and under-performed
            # interview-only profiling; 0.25*conf recovers the DB's value
            # as a correction rather than a replacement.
            score = (1 - 0.25 * conf) * score + 0.25 * conf * sat_est
            source = "blend"
        out.append(
            ScoredLevel(
                bits=bits,
                score=float(score),
                reward=float(reward),
                penalty=float(penalty),
                contribution=float(c_q),
                source=source,
            )
        )
    return out


def select_level(levels: Sequence[ScoredLevel]) -> ScoredLevel:
    return max(levels, key=lambda l: l.score)  # Eq (4)
