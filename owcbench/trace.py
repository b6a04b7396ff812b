"""The traced run: host spans, the device's timeline from ``torch.profiler``, and
what the metric readers and the breakdown take from them.

The profiler records the device alone (CUDA activity), so the host is not
slowed op by op. The host's side is the spans the harness records around the
program's calls (its phases, host stage timers, decode steps). One marker
kernel, launched right after a synchronisation as the trace starts, ties the
two clocks together to within the launch latency.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Spans:
    """Host spans (name, start, end on ``time.perf_counter``, main thread?)."""

    items: list = field(default_factory=list)
    main: int = field(default_factory=threading.get_ident)

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append((name, t0, t1, threading.get_ident() == self.main))


def device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start s, end s) of every device operation in the trace, on the
    profiler's clock (its Kineto results)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
            start = e.start_ns() * 1e-9
            out.append((e.name(), start, start + e.duration_ns() * 1e-9))
    return out


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class _Activity:
    """What the host was doing at a time: the innermost span covering it, the
    main thread's before a worker's. The spans are cut at every boundary into
    segments, each labelled once, and a time is found by bisection."""

    def __init__(self, spans: Spans) -> None:
        items = spans.items
        self.bounds = sorted({t for _, t0, t1, _ in items for t in (t0, t1)})
        self.labels = []
        for a, b in zip(self.bounds, self.bounds[1:]):
            mid = (a + b) / 2
            label = "outside spans"
            for main in (True, False):
                covering = [(t1 - t0, name) for name, t0, t1, m in items if m == main and t0 <= mid <= t1]
                if covering:
                    label = min(covering)[1]
                    break
            self.labels.append(label)

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.bounds, t) - 1
        return self.labels[i] if 0 <= i < len(self.labels) else "outside spans"


@dataclass
class Timeline:
    busy_s: float
    window_s: float
    kernel_s: dict
    breakdown: dict


def analyse(events: list, spans: Spans, window: tuple[float, float], marker: tuple[float, float],
            top: int = 10) -> Timeline:
    """Device busy seconds and kernel seconds by name inside the host window
    ``(start, end)``, and the breakdown: the device operations that took most
    time, and the idle gaps summed by what the host was doing. ``marker`` is
    (host time of the marker's launch, its start on the profiler's clock)."""
    offset = marker[1] - marker[0]  # profiler clock minus host clock
    lo, hi = window[0] + offset, window[1] + offset
    kernel_s: dict[str, float] = defaultdict(float)
    inside = []
    for name, s, e in events:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            kernel_s[name] += e - s
            inside.append((s, e))
    busy = _merge(inside)
    busy_s = sum(e - s for s, e in busy)
    gaps: dict[str, float] = defaultdict(float)
    activity = _Activity(spans)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for gs, ge in zip(edges[::2], edges[1::2]):
        if ge > gs:
            gaps[activity.at((gs + ge) / 2 - offset)] += ge - gs
    by_time = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    breakdown = {"device_ops": [[name[:160], s] for name, s in by_time],
                 "idle_gaps": [[name, s] for name, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}
    return Timeline(busy_s, window[1] - window[0], dict(kernel_s), breakdown)


def marker_kernel() -> float:
    """Synchronise, then launch one small kernel; returns the host time of the launch."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.ones(1, device="cuda").add_(1)
    return t


def first_event_start(events: list) -> float:
    return min(s for _, s, _ in events)
