"""Telemetry of the port: span tracing and the metrics registry.

    from repro_torch import obs

    with obs.span("fold", rows=k):
        ...
    obs.metrics.inc("ota.uplink_bytes", nbytes)
"""

from repro_torch.obs import metrics, trace
from repro_torch.obs.trace import enabled, is_enabled, span

__all__ = ["enabled", "is_enabled", "metrics", "span", "trace"]
