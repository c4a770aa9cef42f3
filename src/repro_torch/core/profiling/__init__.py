"""User profiling and precision planning (host Python, copied from the
JAX package's ``core/profiling/`` with its imports rewritten)."""

from repro_torch.core.profiling.planner import (
    PlanDecision,
    RAGPlanner,
    UnifiedTierPlanner,
    plan_round,
)

__all__ = ["PlanDecision", "RAGPlanner", "UnifiedTierPlanner", "plan_round"]
