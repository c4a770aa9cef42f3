"""Telemetry of the port: span tracing, the metrics registry, and the
JSONL / Perfetto exporters (the JAX package's ``obs/``, without its
``jax.monitoring`` hook).

    from repro_torch import obs

    with obs.span("fold", rows=k):
        ...
    obs.metrics.inc("ota.uplink_bytes", nbytes)

Tracing is off by default and ``obs.span`` is a near-no-op then;
``with obs.enabled(): ...`` turns one block's tracing on,
``obs.disabled()`` forces it off. Metrics are always-on host arithmetic.
"""

from repro_torch.obs import export, metrics, trace
from repro_torch.obs.trace import (
    NULL_SPAN,
    SpanEvent,
    Tracer,
    disabled,
    enabled,
    get_tracer,
    is_enabled,
    span,
    traced,
)

__all__ = [
    "NULL_SPAN",
    "SpanEvent",
    "Tracer",
    "disabled",
    "enabled",
    "export",
    "get_tracer",
    "is_enabled",
    "metrics",
    "span",
    "trace",
    "traced",
]
