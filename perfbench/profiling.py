"""Reductions of a ``torch.profiler`` trace and CUDA-event timings.

From a profile over a few steps: the device's busy seconds (the union of
its kernels' intervals), the kernels that took the most time by name,
and the longest idle stretches of the device grouped by the host
operation that was running at their middle (the latest-started CPU event
still open then).
"""

from __future__ import annotations

import heapq
import statistics
from typing import Callable, Dict, List, Tuple

import torch


def cuda_ms(fn: Callable, reps: int = 3, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _events(prof, annotations=()):
    """(device kernels, host events) as (start, end, name); the device-side
    copies of ``record_function`` ranges are not kernels."""
    kernels, host = [], []
    for e in prof.events():
        kind = getattr(getattr(e, "device_type", None), "name", "CPU")
        iv = (float(e.time_range.start), float(e.time_range.end), e.name)
        if kind != "CUDA":
            host.append(iv)
        elif not getattr(e, "is_user_annotation", False) and e.name not in annotations:
            kernels.append(iv)
    return kernels, host


def reduce_profile(prof, annotations=(), top: int = 10) -> Dict:
    """{busy_s, span_s, device_ops [[name, s]], idle_gaps [[name, s]]}; the
    trace's times are microseconds."""
    kernels, host = _events(prof, annotations)
    busy = union([(s, e) for s, e, _ in kernels])
    by_name: Dict[str, float] = {}
    for s, e, name in kernels:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s) / 1e6
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    by_host: Dict[str, float] = {}
    opens: List[Tuple[float, float, str]] = []  # (-start, end, name)
    ops = sorted(host)
    j = 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        while j < len(ops) and ops[j][0] <= mid:
            heapq.heappush(opens, (-ops[j][0], ops[j][1], ops[j][2]))
            j += 1
        while opens and opens[0][1] < mid:
            heapq.heappop(opens)
        name = opens[0][2][:120] if opens else "(no host op)"
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0) / 1e6
    busy_s = sum(e - s for s, e in busy) / 1e6
    span_s = (busy[-1][1] - busy[0][0]) / 1e6 if busy else 0.0
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"busy_s": busy_s, "span_s": span_s, "kernels": len(kernels),
            "device_ops": rank(by_name), "idle_gaps": rank(by_host)}
