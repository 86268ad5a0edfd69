"""The port's spans and counters: one in-process recorder, off by default.

    from stcat_tpu_torch.core import trace
    trace.enable()
    with trace.span("serve.batch", real=1, lanes=2):
        ...
    out = trace.drain()  # {"spans": [...], "counters": {...}, "anchors": [...]}

``span(name, **attrs)`` is a context manager. With the recorder off it
returns one shared object that does nothing: no allocation and no clock
read, only the check of a module flag. With it on it records the name, the
start and end on ``time.perf_counter_ns()`` (the benchmark's clock), the
thread (its ident and name), the parent (the innermost span open on the
same thread) and ``attrs``, appended to an in-memory list without a lock
(``list.append`` is atomic under the GIL). A span times the host only: it
never synchronizes the card, whose side comes from ``torch.profiler``.
``Span(name)`` is a span that reads the clock whether the recorder is on
or not, for callers that use its times themselves (the training loop's
``data_time`` and ``step_time``); it is recorded only when the recorder is
on. ``record`` adds a span whose times the caller already holds.

``Counter(name)`` counts whether the recorder is on or off; every counter is
registered by its name and ``drain()`` reports its value (counters are not
reset by a drain): the kernels' launch counters ``k1.launches``,
``k2.launches`` and ``k3.launches``, ``k3.dilated`` (the K3 launches at
dilation 2), ``k3.folds``, the forwards that rebuilt the backbone's folded
weights, ``serve.forwards``, the forwards ``predict_batch`` launched, and
``serve.staged_ready``, ``serve.staged_waited`` and ``serve.unstaged``, how
``prepare`` found each request's staging (``serve.py``).
``drain()`` returns and clears the spans (``drain(keep=True)`` leaves
them), with two clock anchors,
``(time.time_ns(), time.perf_counter_ns())``, one sampled at ``enable()``
and one at the drain: they map the spans onto the profiler's wall clock
(``to_wall``, ``chrome_events``), and their offsets differ by the wall
clock's drift against ``perf_counter`` over the recorded interval.

Spans sit at the boundaries of requests, batches and steps (``serve.py``,
``eval/engine.py``, ``train/loop.py``, ``train/step.py``,
``core/prefetch.py``), and inside the models' forward code only around
the backbone's rebuild of its folded weights (``backbone.fold``, once per
weight version, ``models/resnet.py``): a forward launches thousands of
kernels, and their device time needs events on the card. Where an operator reads them: ``cli/serve.py --trace`` answers them
at ``GET /trace``, ``cli/test.py --trace`` writes the evaluation's to
OUTPUT_DIR/trace, and TPU.PROFILE_STEP adds the profiled training steps'
to its profiler trace, each a Chrome trace.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

_on = False
_spans: List["Span"] = []
_enabled_at: Optional[Tuple[int, int]] = None
_ids = itertools.count(1)
_local = threading.local()
_counters: Dict[str, "Counter"] = {}
_counters_lock = threading.Lock()


def _anchor() -> Tuple[int, int]:
    return time.time_ns(), time.perf_counter_ns()


def _stack() -> List["Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The span handed out while the recorder is off."""

    __slots__ = ()
    start = end = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **attrs) -> None:
        pass


OFF = _Off()


class Span:
    """A named host interval on ``perf_counter_ns``; recorded at its end if
    the recorder is on then."""

    __slots__ = ("name", "attrs", "start", "end", "id", "parent", "thread", "thread_name")

    def __init__(self, name: str, attrs: Optional[Dict] = None):
        self.name, self.attrs = name, attrs or {}
        self.start = self.end = self.parent = None

    def note(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if _on:
            t = threading.current_thread()
            self.thread, self.thread_name = t.ident, t.name
            _spans.append(self)
        return False

    def as_dict(self) -> Dict:
        return {"name": self.name, "start_ns": self.start, "end_ns": self.end, "id": self.id,
                "parent": self.parent, "thread": self.thread, "thread_name": self.thread_name,
                "attrs": dict(self.attrs)}


def span(name: str, **attrs):
    """A recorded span when the recorder is on, else the shared ``OFF``."""
    if not _on:
        return OFF
    return Span(name, attrs)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Record a finished span whose times the caller holds (on this thread,
    under its innermost open span); nothing when the recorder is off."""
    if not _on:
        return
    s = Span(name, attrs)
    stack = _stack()
    s.parent = stack[-1].id if stack else None
    s.id, s.start, s.end = next(_ids), start_ns, end_ns
    t = threading.current_thread()
    s.thread, s.thread_name = t.ident, t.name
    _spans.append(s)


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start recording spans (anchoring the clocks on the first call)."""
    global _on, _enabled_at
    if not _on:
        _enabled_at = _anchor()
        _on = True


def disable() -> None:
    global _on
    _on = False


def drain(keep: bool = False) -> Dict:
    """The spans recorded since the last drain (as dicts, in the order they
    ended), cleared here unless ``keep``; every counter's value; the clock
    anchors taken at ``enable()`` (or the last clearing drain) and now."""
    global _enabled_at
    taken = _spans[:]
    now = _anchor()
    anchors = [_enabled_at or now, now]
    if not keep:
        del _spans[:len(taken)]
        if _on:
            _enabled_at = now
    with _counters_lock:
        counters = {name: c.count for name, c in _counters.items()}
    return {"spans": [s.as_dict() for s in taken], "counters": counters, "anchors": anchors}


def to_wall(perf_ns: int, anchors) -> int:
    """A ``perf_counter_ns`` time on the wall clock (``time.time_ns()``,
    the profiler's), through the anchor taken at ``enable()``."""
    wall, perf = anchors[0]
    return perf_ns + (wall - perf)


def chrome_events(drained: Dict, base_ns: int = 0) -> List[Dict]:
    """The drained spans as Chrome trace events on the profiler's clock
    (microseconds of the wall clock since ``base_ns``, the trace's
    ``baseTimeNanoseconds``), one row per thread, named."""
    pid = os.getpid()
    events, threads = [], {}
    for s in drained["spans"]:
        threads[s["thread"]] = s["thread_name"]
        events.append({"ph": "X", "cat": "stcat_tpu_torch", "name": s["name"], "pid": pid,
                       "tid": s["thread"], "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "ts": (to_wall(s["start_ns"], drained["anchors"]) - base_ns) / 1e3,
                       "args": s["attrs"]})
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": name}} for tid, name in threads.items()]
    return events


class Counter:
    """A named count (thread-safe), registered for ``drain()``."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0
        with _counters_lock:
            if name in _counters:
                raise ValueError(f"a counter named {name!r} exists already")
            _counters[name] = self

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    def reset(self) -> None:
        with self._lock:
            self.count = 0
