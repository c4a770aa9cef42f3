"""Process-local metrics registry: counters, gauges, histograms (the JAX
package's ``obs/metrics.py`` without its ``jax.monitoring`` hook).

Labels qualify a series: ``inc("ota.rows", 3, kind="int4")`` keys the
series ``ota.rows{kind=int4}``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict


def _series(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Registry:
    """Thread-safe process-local metrics store."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Dict[str, float]] = {}

    def inc(self, name: str, value: float = 1.0, **labels: Any) -> None:
        key = _series(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        key = _series(name, labels)
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name: str, value: float, **labels: Any) -> None:
        key = _series(name, labels)
        v = float(value)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                self._hists[key] = {"count": 1, "total": v, "min": v, "max": v}
            else:
                h["count"] += 1
                h["total"] += v
                h["min"] = min(h["min"], v)
                h["max"] = max(h["max"], v)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: dict(v) for k, v in self._hists.items()},
            }


REGISTRY = Registry()

inc = REGISTRY.inc
set_gauge = REGISTRY.set_gauge
observe = REGISTRY.observe
snapshot = REGISTRY.snapshot
