from repro_torch.fl.client import FLClient, LatencyModel
from repro_torch.fl.server import (
    FLServer,
    RoundLog,
    StreamingFLServer,
    StreamPlan,
    StreamRoundLog,
    make_planner,
    plan_stream,
)

__all__ = [
    "FLClient",
    "FLServer",
    "LatencyModel",
    "RoundLog",
    "StreamPlan",
    "StreamRoundLog",
    "StreamingFLServer",
    "make_planner",
    "plan_stream",
]
