"""Observability: per-phase timers and device profiling (port of
`bundle_adjustment_tpu/solver/tracing.py`).

The reference's only tracing is the PropertyChangeEvent stream
(BundleAdjustment.java:72 ff., survey section 5).  Here the same state
machine drives structured per-phase timing, and a `torch.profiler` trace
(host operators and, on a card, its kernels and copies) can be captured
around the estimation and opened in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

#: file name of the Chrome trace `device_trace` writes into its logdir
TRACE_FILE = "trace.json"


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per estimation phase; attach via
    ``adjustment.add_property_change_listener(timer.listener)``."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    events: list = field(default_factory=list)
    _current: str = ""
    _t0: float = 0.0

    def listener(self, name: str, old, new) -> None:
        now = time.perf_counter()
        if self._current:
            self.totals[self._current] += now - self._t0
            self.counts[self._current] += 1
        self._current = name
        self._t0 = now
        self.events.append((now, name, old, new))

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


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block (CPU operators,
    and CUDA kernels and copies where a card is present) and write it as a
    Chrome trace to ``logdir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
