"""Telemetry export: a JSONL event sink, the summary rollup, and the
benchmark-report writer (the JAX package's ``obs/export.py``).

- :class:`JsonlSink`: append-only JSON-lines event stream, one object a
  line (``{"ts": <unix seconds>, "kind": ..., "name": ..., ...}``).
  ``dump_telemetry`` writes the metrics registry and the span rollup
  through it, and the Perfetto trace beside it.
- :func:`summary`: one nested dict (metrics + per-span rollup).
- :func:`write_bench_report`: one ``BENCH_<name>.json``. The reference's
  ``write_all_bench_reports`` imports its own benchmarks, which run the
  JAX package; it waits until the port has benchmarks of its own.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


class JsonlSink:
    """Append-only JSONL event sink (one JSON object per line)."""

    def __init__(self, path: str, *, clock=time.time):
        self.path = path
        self._clock = clock
        self._f = open(path, "a")

    def emit(self, kind: str, name: str, **fields: Any) -> None:
        rec = {"ts": self._clock(), "kind": kind, "name": name}
        rec.update(fields)
        self._f.write(json.dumps(rec, sort_keys=True))
        self._f.write("\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def summary(
    *,
    registry: Optional[_metrics.Registry] = None,
    tracer: Optional[_trace.Tracer] = None,
) -> Dict[str, Any]:
    """One snapshot dict: metrics registry + per-span-name rollup."""
    registry = registry or _metrics.REGISTRY
    tracer = tracer or _trace.get_tracer()
    return {"metrics": registry.snapshot(), "spans": tracer.summary()}


def dump_telemetry(
    jsonl_path: str,
    trace_path: Optional[str] = None,
    *,
    registry: Optional[_metrics.Registry] = None,
    tracer: Optional[_trace.Tracer] = None,
) -> Dict[str, Any]:
    """Flush current telemetry to disk; returns the summary written.

    Each metric series becomes one JSONL event (``kind`` = counter /
    gauge / histogram, ``value`` the float or the {count,total,min,max}
    dict), each span name one ``kind: "span"`` rollup line. With
    ``trace_path`` the Perfetto ``trace_event`` JSON is written too.
    """
    s = summary(registry=registry, tracer=tracer)
    with JsonlSink(jsonl_path) as sink:
        for kind in ("counters", "gauges", "histograms"):
            for name, value in sorted(s["metrics"][kind].items()):
                sink.emit(kind[:-1], name, value=value)
        for name, roll in sorted(s["spans"].items()):
            sink.emit("span", name, **roll)
    if trace_path is not None:
        (tracer or _trace.get_tracer()).export_perfetto(trace_path)
    return s


def write_bench_report(
    name: str, payload: Dict[str, Any], directory: str = "."
) -> str:
    """Write one ``BENCH_<name>.json`` (sorted, indented, newline-
    terminated) and return its path."""
    path = f"{directory}/BENCH_{name}.json"
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}")
    return path
