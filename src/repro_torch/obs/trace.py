"""Host-side span tracer (the JAX package's ``obs/trace.py``, cut to the
calls the round path makes).

One process-global :class:`Tracer` records named, nested host-time
intervals around the FL round stages. Spans time the *host*: CUDA
launches are asynchronous, so a span around a launch times the enqueue
unless something inside synchronises. Disabled by default, and then
``span()`` returns a shared no-op context manager.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, Iterator, List, Optional


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    name: str
    ts_us: float
    dur_us: float
    depth: int
    tid: int
    args: Optional[Dict[str, Any]] = None


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        local = self._tracer._local
        self._depth = getattr(local, "depth", 0)
        local.depth = self._depth + 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter_ns()
        tracer = self._tracer
        tracer._local.depth = self._depth
        if tracer.enabled:
            tracer._events.append(
                SpanEvent(
                    name=self._name,
                    ts_us=(self._t0 - tracer._epoch_ns) / 1e3,
                    dur_us=(t1 - self._t0) / 1e3,
                    depth=self._depth,
                    tid=threading.get_ident(),
                    args=self._args or None,
                )
            )
        return False


class Tracer:
    """Process-local span recorder. Disabled (and empty) by default."""

    def __init__(self) -> None:
        self.enabled = False
        self._events: List[SpanEvent] = []
        self._epoch_ns = time.perf_counter_ns()
        self._local = threading.local()

    def reset(self) -> "Tracer":
        self._events = []
        self._epoch_ns = time.perf_counter_ns()
        return self

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name {count, total_us, max_us} rollup."""
        out: Dict[str, Dict[str, float]] = {}
        for e in self._events:
            s = out.setdefault(e.name, {"count": 0, "total_us": 0.0, "max_us": 0.0})
            s["count"] += 1
            s["total_us"] += e.dur_us
            s["max_us"] = max(s["max_us"], e.dur_us)
        return out


_TRACER = Tracer()


def is_enabled() -> bool:
    return _TRACER.enabled


def span(name: str, **args: Any) -> Any:
    """``with span("fold"): ...`` — one attribute check when disabled."""
    t = _TRACER
    if not t.enabled:
        return NULL_SPAN
    return _Span(t, name, args if args else None)


@contextlib.contextmanager
def enabled(*, fresh: bool = True) -> Iterator[Tracer]:
    """Enable tracing for the block; restore the prior state after."""
    t = _TRACER
    prev = t.enabled
    if fresh:
        t.reset()
    t.enabled = True
    try:
        yield t
    finally:
        t.enabled = prev
