"""The benchmark's spans and its reading of the profiler's device timeline.

``Spans`` records named host intervals around calls into the port, on the
``perf_counter`` clock. ``Trace`` runs ``torch.profiler`` with the CUDA
activity alone (the device's kernels, copies and sets; recording every host
op would slow the host-bound step several times) over part of the window,
and reduces its events: their union inside the traced window, the device
operations that took most time, and the idle gaps named by the benchmark
span the host was in when each began. The profiler's timestamps are
wall-clock nanoseconds; ``Trace`` samples the wall clock beside
``perf_counter`` when it starts, which maps the spans and the window onto
the trace.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import stats

WINDOW = "portbench.window"


class Spans:
    """Named host intervals (perf_counter seconds), from any thread."""

    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.records.append((name, t0, t1))

    def total(self, name: str, lo: float, hi: float) -> float:
        """Seconds of [lo, hi] inside spans called ``name``."""
        return stats.covered([(a, b) for n, a, b in self.records if n == name], lo, hi)

    def durations(self, name: str, lo: float, hi: float) -> List[float]:
        return [b - a for n, a, b in self.records if n == name and a >= lo and b <= hi]


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: int
    by_name: Dict[str, float] = field(default_factory=dict)
    count_by_name: Dict[str, int] = field(default_factory=dict)
    idle_by_span: Dict[str, float] = field(default_factory=dict)

    def device_ops(self, n: int = 10) -> List[List]:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], seconds] for name, seconds in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        top = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:n]
        return [[name, seconds] for name, seconds in top]

    def seconds_of(self, fragments) -> float:
        return sum(s for name, s in self.by_name.items() if any(f in name for f in fragments))

    def count_of(self, fragments) -> int:
        return sum(c for name, c in self.count_by_name.items() if any(f in name for f in fragments))


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def summarize(device: List[Tuple[float, float, str]], host: List[Tuple[float, float, str]],
              lo: float, hi: float) -> TraceSummary:
    """Reduce device intervals (start, end, name) and host spans to the
    window [lo, hi], all on one clock in seconds."""
    inside = [(s, e, n) for s, e, n in device if e > lo and s < hi]
    intervals = stats.clip_to([(s, e) for s, e, _ in inside], lo, hi)
    by_name: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    kernels = 0
    for (s, e), (_, _, name) in zip(intervals, inside):
        by_name[name] += e - s
        counts[name] += 1
        kernels += not _is_copy(name)
    idle: Dict[str, float] = defaultdict(float)
    host = sorted(host)
    for gs, ge in stats.gaps(intervals, lo, hi):
        # the innermost benchmark span open when the gap began
        open_ = [(s, n) for s, e, n in host if s <= gs < e]
        idle[max(open_)[1] if open_ else "outside spans"] += ge - gs
    return TraceSummary(window_s=hi - lo, busy_s=stats.covered(intervals, lo, hi),
                        kernels=kernels, by_name=dict(by_name), count_by_name=dict(counts),
                        idle_by_span=dict(idle))


class Trace:
    """torch.profiler's CUDA activity over [start(), stop()]."""

    def __init__(self, spans: Spans, cuda: bool = True):
        self.spans, self.cuda = spans, cuda
        self.prof = None
        self.window = None
        self.summary: Optional[TraceSummary] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA] if self.cuda
                            else [ProfilerActivity.CPU])
        self.offset = time.time_ns() * 1e-9 - time.perf_counter()
        self.prof.start()
        self.window = [time.perf_counter(), None]

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.window[1] = time.perf_counter()
        self.prof.stop()

    def reduce(self) -> Optional[TraceSummary]:
        """The summary of the traced window (once; None without a trace)."""
        if self.prof is None:
            return self.summary
        from torch.autograd import DeviceType

        device = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                start = e.start_ns() * 1e-9 - self.offset
                device.append((start, start + e.duration_ns() * 1e-9, e.name()))
        self.prof = None
        self.summary = summarize(device, [(a, b, n) for n, a, b in self.spans.records],
                                 *self.window)
        return self.summary
