"""The device's timeline over one profiled job, and kernel chains.

`profile` runs one job under the PyTorch profiler (device activities
and CUDA runtime calls) and reduces the trace: the device is busy where the union of
its activities (kernels, copies, sets) covers the job's host span; the
rest of that span is idle.  Each idle gap is named by the innermost CUDA
runtime call that covers its middle ("host" where none does: the host
was in Python or in PyTorch between calls).  The busy/idle arithmetic is the port's
`measure.device_profile` one (union of device intervals over a window,
the window idle `LEAD_S` before and after the work) as it stood when the
benchmark was written.

`per_call_ms` times a kernel in chains between two CUDA events, after a
few untimed calls: (T_end - T_start) / calls, as the port's
`bench.chain_s` does."""

from __future__ import annotations

import bisect
import time
from typing import NamedTuple

#: host seconds the profile idles before and after the job: torch.profiler
#: now and then drops the first device records of a window
LEAD_S = 0.02
#: entries of each list in the breakdown
TOP = 10
#: host calls that start before an idle gap's middle, nearest first, of
#: which the innermost covering one names the gap (runtime calls barely
#: nest)
COVER = 8


class Profile(NamedTuple):
    busy_s: float        # union of device activity inside the job's span
    window_s: float      # the job's host span
    device_ops: list     # [[name, seconds]] by total device time
    idle_gaps: list      # [[host op, seconds]] idle time by host op


def union_s(intervals, lo, hi) -> float:
    """Length of the union of ``intervals`` [(start, end)] clipped to
    [lo, hi] (any unit)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals
                       if e > lo and s < hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi) -> list:
    """The stretches [(start, end)] of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def reduce_events(events, lo, hi) -> Profile:
    """``events``: [(name, on_device, start_ns, end_ns)] of one profile;
    [lo, hi] the job's host span (ns, the same clock)."""
    dev = [(n, s, e) for n, d, s, e in events if d]
    busy = union_s([(s, e) for _, s, e in dev], lo, hi)
    by_op = {}
    for n, s, e in dev:
        if e > lo and s < hi:
            by_op[n[:60]] = by_op.get(n[:60], 0) + min(e, hi) - max(s, lo)
    host = sorted((s, e, n) for n, d, s, e in events
                  if not d and s <= hi and e >= lo)
    starts = [h[0] for h in host]
    idle = {}
    for s, e in gaps([(s, e) for _, s, e in dev], lo, hi):
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid)
        cover = [(he - hs, n) for hs, he, n in host[max(0, i - COVER):i]
                 if he >= mid]
        name = min(cover)[1][:60] if cover else "host"
        idle[name] = idle.get(name, 0) + (e - s)

    def top(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Profile(busy_s=busy / 1e9, window_s=(hi - lo) / 1e9,
                   device_ops=top(by_op), idle_gaps=top(idle))


def profile(fn) -> Profile:
    """Run fn() once under the PyTorch profiler (Kineto), tracing the
    device and the CUDA runtime only (host ops are not traced: their
    recording would double a host-bound job), and reduce the raw events
    (`reduce_events`) over the job's host span.  The raw events are read
    as the profiler returns them: torch.profiler's own post-processing of
    a device-only trace grows with the square of its launches."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (DeviceType, ProfilerActivity,
                                ProfilerConfig, ProfilerState,
                                _disable_profiler, _enable_profiler,
                                _prepare_profiler)

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                            False, False, _ExperimentalConfig())
    activities = {ProfilerActivity.CUDA}
    torch.cuda.synchronize()
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities)
    try:
        time.sleep(LEAD_S)
        lo = time.time_ns()
        fn()
        torch.cuda.synchronize()
        hi = time.time_ns()
        time.sleep(LEAD_S)
    finally:
        result = _disable_profiler()
    events = [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
               e.end_ns()) for e in result.events()]
    return reduce_events(events, lo, hi)


def per_call_ms(fn, warm=4, calls=32, chains=3) -> float:
    """Median over ``chains`` chains of ``calls`` back-to-back fn() calls
    between two CUDA events, ms per call, after ``warm`` untimed calls."""
    import statistics

    import torch

    for _ in range(warm):
        fn()
    out = []
    for _ in range(chains):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / calls)
    return statistics.median(out)
