from repro_torch.fl.client import FLClient, LatencyModel
from repro_torch.fl.server import FLServer, RoundLog, make_planner

__all__ = ["FLClient", "FLServer", "LatencyModel", "RoundLog", "make_planner"]
