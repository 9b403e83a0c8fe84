"""Observability: per-phase timers, program spans and device profiling
(port of `bundle_adjustment_tpu/solver/tracing.py`).

The reference's only tracing is the PropertyChangeEvent stream
(BundleAdjustment.java:72 ff., survey section 5).  Here the same state
machine drives structured per-phase timing (`PhaseTimer`), and a
`torch.profiler` trace (host operators and, on a card, its kernels and
copies) can be captured around the estimation and opened in Perfetto or
chrome://tracing (`device_trace`).

Program spans: the port marks its layer boundaries with `span(name)`
(the LM driver, the step, the linearisation, the assembly, PCG, the
back-substitution, the refinement, each CUDA kernel launch and the
covariance's stages).  Recording is off outside a `recording` block:
there `span` returns one shared no-op object, and the call sites made on
every CG iteration (the kernel launches) test `ACTIVE` first.
Spans are stamped with `time.time_ns()`, the clock of the profiler's
raw events (Kineto's ``start_ns``), so a span and a device event compare
without a conversion; `device_trace` writes the spans of its block into
its Chrome trace.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

#: file name of the Chrome trace `device_trace` writes into its logdir
TRACE_FILE = "trace.json"
#: the Chrome trace's thread row of the program spans
SPAN_TID = 0

#: True while a `recording` block is open: the guard of the call sites
#: made on every CG iteration
ACTIVE = False
_spans: list = []       # the open recording's spans, in opening order
_stack: list = []       # indices of its open spans, innermost last
_job = None             # the open recording's job id


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per estimation phase; attach via
    ``adjustment.add_property_change_listener(timer.listener)``."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    _current: str = ""
    _t0: float = 0.0

    def listener(self, name: str, old, new) -> None:
        now = time.perf_counter()
        if self._current:
            self.totals[self._current] += now - self._t0
            self.counts[self._current] += 1
        self._current = name
        self._t0 = now

    def report(self) -> str:
        if self._current:
            now = time.perf_counter()
            self.totals[self._current] += now - self._t0
            self.counts[self._current] += 1
            self._current = ""
        lines = ["phase                              count      total [s]"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<32} {self.counts[name]:>6} {total:>14.3f}")
        return "\n".join(lines)


@dataclass(slots=True)
class Span:
    """One recorded span: ``start_ns`` / ``end_ns`` on `time.time_ns`,
    ``parent`` the index of the enclosing span in the recording (-1: none),
    ``job`` the recording's job id, ``counts`` what `count` added."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int
    job: object
    counts: dict


class _Open:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _spans.append(Span(self.name, time.time_ns(), None,
                           _stack[-1] if _stack else -1, _job, {}))
        _stack.append(len(_spans) - 1)

    def __exit__(self, *exc):
        _spans[_stack.pop()].end_ns = time.time_ns()
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """Context manager: a span ``name`` around its block while recording.
    A span opened directly inside one of the same name is not recorded
    (`engine.lm_step_full` without extras is `engine.lm_step`)."""
    if not ACTIVE or (_stack and _spans[_stack[-1]].name == name):
        return _OFF
    return _Open(name)


def traced(name: str):
    """Decorator: every call of the function in a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not ACTIVE:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``name`` of the innermost open span."""
    if ACTIVE and _stack:
        counts = _spans[_stack[-1]].counts
        counts[name] = counts.get(name, 0) + n


@contextlib.contextmanager
def recording(job=None):
    """Record the spans of the enclosed block, each carrying ``job``;
    yields the list they are kept in (filled as they open; nothing is
    written anywhere).  Recordings do not nest."""
    global ACTIVE, _spans, _stack, _job
    if ACTIVE:
        raise RuntimeError("a recording is already open")
    _spans, _stack, _job = [], [], job
    ACTIVE = True
    try:
        yield _spans
    finally:
        ACTIVE = False
        _stack, _job = [], None


def _add_spans(path: str, spans: list) -> None:
    """Write ``spans`` into the Chrome trace at ``path`` as complete events
    on its own time base (``baseTimeNanoseconds``), on a thread row of
    their own."""
    with open(path) as fh:
        trace = json.load(fh)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": SPAN_TID, "args": {"name": "program spans"}})
    for i, s in enumerate(spans):
        events.append({"ph": "X", "cat": "program_span", "name": s.name,
                       "pid": pid, "tid": SPAN_TID,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"index": i, "parent": s.parent,
                                "job": s.job, **s.counts}})
    with open(path, "w") as fh:
        json.dump(trace, fh)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block (CPU operators,
    and CUDA kernels and copies where a card is present) and write it as a
    Chrome trace to ``logdir/trace.json``, with the program spans recorded
    in the block on a row of their own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof, recording() as spans:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _add_spans(path, spans)
