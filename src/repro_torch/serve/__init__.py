"""Serving runtime of the port: the continuous-batching engine."""

from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
