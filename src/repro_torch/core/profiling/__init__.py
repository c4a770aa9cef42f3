"""User profiling and precision planning (host Python, copied from the
JAX package's ``core/profiling/`` with its imports rewritten)."""

from repro_torch.core.profiling.evaluator import (
    contribution_multiplier,
    evaluate_levels,
    select_level,
)
from repro_torch.core.profiling.hardware import (
    DeviceSpec,
    hardware_tier,
    make_fleet,
    max_feasible_bits,
)
from repro_torch.core.profiling.interview import InferredProfile, InterviewAgent, SimLLM
from repro_torch.core.profiling.planner import (
    PlanDecision,
    RAGPlanner,
    UnifiedTierPlanner,
    plan_round,
)
from repro_torch.core.profiling.ragdb import (
    ContextQuantFeedbackDB,
    HardwareQuantPerfDB,
    VectorStore,
    embed_batch,
    embed_features,
)
from repro_torch.core.profiling.users import (
    UserTruth,
    make_users,
    satisfaction_score,
    true_performance,
)

__all__ = [
    "ContextQuantFeedbackDB",
    "DeviceSpec",
    "HardwareQuantPerfDB",
    "InferredProfile",
    "InterviewAgent",
    "PlanDecision",
    "RAGPlanner",
    "SimLLM",
    "UnifiedTierPlanner",
    "UserTruth",
    "VectorStore",
    "contribution_multiplier",
    "embed_batch",
    "embed_features",
    "evaluate_levels",
    "hardware_tier",
    "make_fleet",
    "make_users",
    "max_feasible_bits",
    "plan_round",
    "satisfaction_score",
    "select_level",
    "true_performance",
]
