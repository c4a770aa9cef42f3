"""Precision planners: the paper's RAG planner, the unified-tier baseline,
and the server-side multi-client quantization planning step.

``RAGPlanner`` runs the 6-step user-profiling pipeline (paper §III-B3):
  1. hardware specification extraction
  2. hardware-quantization-performance trade-off retrieval
  3. user interview feedback collection
  4. contextual factor inference
  5. user preference / contextual factor retrieval
  6. satisfaction + contribution estimation  ->  Eqs (1)-(4)

Two entry points share the pipeline: ``plan`` runs it per client (the
readable specification), ``plan_cohort`` batches step (2) and (5) across
the whole cohort — embed every client's context and hardware features
once, then issue ONE batched engine query per store per round instead of
a numpy scan per client (DESIGN.md §10). The FL server's round loop uses
``plan_cohort``.

``UnifiedTierPlanner`` is the paper's §IV comparison: tier clients by
hardware capability alone; every tier member gets the same bits.

``plan_round`` implements the FL server's "multi-client quantization
planning": clients whose top levels have similar merit get nudged into
the precision slots that maximise mixed-precision OTA utilization.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.profiling.evaluator import ScoredLevel, evaluate_levels, select_level
from repro_torch.core.profiling.hardware import (
    TIER_BITS,
    DeviceSpec,
    hardware_tier,
    max_feasible_bits,
)
from repro_torch.core.profiling.interview import InferredProfile, InterviewAgent
from repro_torch.core.profiling.ragdb import (
    RETRIEVE_K,
    ContextQuantFeedbackDB,
    HardwareQuantPerfDB,
    embed_batch,
)
from repro_torch.core.profiling.users import UserTruth


@dataclasses.dataclass
class PlanDecision:
    user_id: int
    bits: int
    score_est: float
    levels: List[ScoredLevel]
    transcript: str = ""


class BasePlanner:
    name = "base"

    def plan(self, users, specs, **kw) -> List[PlanDecision]:
        raise NotImplementedError

    def plan_cohort(self, users, specs, **kw) -> List[PlanDecision]:
        """Batched planning pass; planners without a batched retrieval
        path fall back to the per-client pipeline."""
        return self.plan(users, specs, **kw)

    def observe_feedback(self, *a, **kw) -> None:
        pass


class UnifiedTierPlanner(BasePlanner):
    """Hardware tiers only — ignores preferences and contexts (paper §IV)."""

    name = "unified"

    def plan(
        self, users: Sequence[UserTruth], specs: Sequence[DeviceSpec], **kw
    ) -> List[PlanDecision]:
        out = []
        for u, s in zip(users, specs):
            bits = min(TIER_BITS[hardware_tier(s)], max_feasible_bits(s))
            # clamp to a supported level
            feasible = [b for b in s.supported_bits if b <= bits]
            bits = max(feasible) if feasible else min(s.supported_bits)
            out.append(PlanDecision(u.user_id, bits, 0.0, []))
        return out


class RAGPlanner(BasePlanner):
    """The paper's planner: interview -> infer -> retrieve -> Eqs (1)-(4)."""

    name = "rag"

    def __init__(
        self,
        *,
        strategy: str = "fedavg",
        energy_priority: float = 1.0,
        seed: int = 0,
        device=None,
    ):
        self.agent = InterviewAgent(seed=seed)
        # both stores query through the engine on ``device`` (the top-k
        # kernel on a CUDA device, its plain version on the CPU)
        self.cqf_db = ContextQuantFeedbackDB(device=device)
        self.hqp_db = HardwareQuantPerfDB(device=device)
        self.strategy = strategy
        self.energy_priority = energy_priority
        self.profiles: Dict[int, InferredProfile] = {}

    def _interview(self, user: UserTruth) -> Tuple[str, InferredProfile]:
        """(3) interview + (4) contextual factor inference — refreshed
        each planning pass; repeated interviews accumulate by field-wise
        max-confidence merge."""
        transcript, prof = self.agent.interview(user)
        prev = self.profiles.get(user.user_id)
        if prev is not None:
            prof = _merge_profiles(prev, prof)
        self.profiles[user.user_id] = prof
        return transcript, prof

    def plan(
        self, users: Sequence[UserTruth], specs: Sequence[DeviceSpec], **kw
    ) -> List[PlanDecision]:
        out = []
        for u, s in zip(users, specs):
            transcript, prof = self._interview(u)
            # (1)(2)(5)(6): hardware extraction + retrievals + Eqs (1)-(4)
            levels = evaluate_levels(
                prof,
                s,
                self.cqf_db,
                self.hqp_db,
                strategy=self.strategy,
                energy_priority=self.energy_priority,
            )
            best = select_level(levels)
            out.append(
                PlanDecision(u.user_id, best.bits, best.score, levels, transcript)
            )
        return out

    def plan_cohort(
        self, users: Sequence[UserTruth], specs: Sequence[DeviceSpec], **kw
    ) -> List[PlanDecision]:
        """The batched pipeline: same decisions as ``plan``, one engine
        query per store for the whole cohort instead of 2K serial scans.

        Steps (3)-(4) stay per client (interviews are conversations);
        steps (2) and (5) embed all K feature dicts once and retrieve in
        one (K, D) batch per store; step (6) scores the pre-fetched hit
        lists per client.
        """
        if type(self).plan is not RAGPlanner.plan:
            # a subclass customized the per-client pipeline (e.g. the
            # ablation planners) — honor it rather than silently running
            # the base pipeline through the batched path
            return self.plan(users, specs, **kw)
        if not users or not specs:
            return []
        interviews = [self._interview(u) for u in users]
        profs = [prof for _, prof in interviews]
        ctx_q = embed_batch([p.features() for p in profs])
        hw_q = embed_batch([s.features() for s in specs])
        ctx_hits = self.cqf_db.query_batch(ctx_q, k=RETRIEVE_K)
        hw_hits = self.hqp_db.query_batch(hw_q, k=RETRIEVE_K)
        out = []
        for i, (u, s) in enumerate(zip(users, specs)):
            levels = evaluate_levels(
                profs[i],
                s,
                self.cqf_db,
                self.hqp_db,
                strategy=self.strategy,
                energy_priority=self.energy_priority,
                ctx_hits=ctx_hits[i],
                hw_hits=hw_hits[i],
            )
            best = select_level(levels)
            transcript = interviews[i][0]
            out.append(
                PlanDecision(u.user_id, best.bits, best.score, levels, transcript)
            )
        return out

    def observe_feedback(
        self,
        user: UserTruth,
        spec: DeviceSpec,
        bits: int,
        satisfaction: float,
        perf: Dict[str, float],
    ) -> None:
        """Close the loop: archive realised outcomes into both DBs."""
        prof = self.profiles.get(user.user_id)
        feats = prof.features() if prof else {}
        self.cqf_db.add_feedback(feats, bits, satisfaction, perf)
        self.hqp_db.add_measurement(spec.features(), bits, perf)


def _merge_profiles(old: InferredProfile, new: InferredProfile) -> InferredProfile:
    merged = InferredProfile(user_id=new.user_id)
    fields = (
        ("location", "location_conf"),
        ("time", "time_conf"),
        ("frequency", "frequency_conf"),
    )
    for field, conf_field in fields:
        o_v, o_c = getattr(old, field), getattr(old, conf_field)
        n_v, n_c = getattr(new, field), getattr(new, conf_field)
        if n_c >= o_c:
            setattr(merged, field, n_v)
            setattr(merged, conf_field, n_c)
        else:
            setattr(merged, field, o_v)
            setattr(merged, conf_field, o_c)
    for f in old.sens:
        merged.sens[f] = 0.6 * old.sens[f] + 0.6 * new.sens[f]
    cats = set(old.category_signal) | set(new.category_signal)
    merged.category_signal = {
        c: max(old.category_signal.get(c, 0.0), new.category_signal.get(c, 0.0))
        for c in cats
    }
    return merged


# ---------------------------------------------------------------------------
# multi-client quantization planning (FL server, paper §III-A)
# ---------------------------------------------------------------------------


def plan_round(
    decisions: List[PlanDecision],
    *,
    merit_epsilon: float = 0.04,
    slot_bits: Sequence[int] = (4, 8, 16, 32),
) -> List[PlanDecision]:
    """Pack near-tied clients into fewer precision slots.

    Mixed-precision OTA aggregation is most spectrally efficient when the
    active precision set is small (fewer constellation alignments). For
    each client whose runner-up level scores within ``merit_epsilon`` of
    its best, prefer the level that is already most popular this round.
    """
    counts: Dict[int, int] = {b: 0 for b in slot_bits}
    for d in decisions:
        counts[d.bits] = counts.get(d.bits, 0) + 1
    out = []
    for d in decisions:
        if d.levels:
            near = [l for l in d.levels if d.score_est - l.score <= merit_epsilon]
            if len(near) > 1:
                best = max(near, key=lambda l: (counts.get(l.bits, 0), l.score))
                if best.bits != d.bits:
                    counts[d.bits] -= 1
                    counts[best.bits] = counts.get(best.bits, 0) + 1
                    d = dataclasses.replace(d, bits=best.bits, score_est=best.score)
        out.append(d)
    return out
