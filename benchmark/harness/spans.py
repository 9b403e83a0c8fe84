"""The port's own spans over a few more jobs, and the device's time put
down to them.

`traced(run)` runs `TRACED_JOBS` more jobs after the window, each under
the port's span recorder (`solver.tracing.recording`, job id k) in a root
span ``job``, and prints the traced jobs' mean seconds against the
window's seconds per job (`adjust_s`, `cov_s`).  The spans' own durations
are host-clock readings of each layer.

`traced_profile(run)` runs one more job under Kineto (device activities
and CUDA runtime calls, as `timeline.profile`, keeping the correlation
ids) and the recorder together.  Both stamp `time.time_ns` (Kineto's
``start_ns``), so `attribute` compares them as they are: a device op is
put down to the innermost span that holds its correlated launch call, an
idle gap of the device to the innermost span that covers its middle.  A
by-span table goes to standard error.

Where the program records no spans (a port without
`tracing.recording`), both return None and their readers read nothing."""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

from . import timeline

#: jobs `traced` records after the window
TRACED_JOBS = 3
#: CUDA runtime calls that launch device work (kernels and graphs)
LAUNCH = "Launch"
#: CUDA runtime calls that wait for the device on the host
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
#: kernel names that K1 and K2 share (the table says whose each one is)
SHARED_KERNELS = ("block_sum_kernel", "finish_kernel")


class Attribution(NamedTuple):
    """The profiled job's device time and idle time by span (ns, each list
    indexed as the spans are)."""
    busy_ns: int           # union of device activity over [lo, hi]
    idle_ns: int           # the rest of [lo, hi]
    device_ns: list        # busy time of the device ops put down to a span
    idle_span_ns: list     # idle time put down to a span
    launches: list         # launch calls the span holds innermost
    syncs: list            # host waits for the device, the same way
    unattributed_ns: int   # busy time of ops whose launch no span holds
    outside_ns: int        # idle time outside every span
    op_span: list          # per device op (in the events' order): span or -1


class SpanProfile(NamedTuple):
    spans: list            # the recorder's spans; the root ``job`` first
    op_names: list         # the device ops' names, as `op_span` is ordered
    attribution: Attribution
    window_ns: int         # the job's host span


def recorder():
    """The port's `solver.tracing` where it records spans, else None."""
    from bundle_adjustment_tpu_torch.solver import tracing

    return tracing if hasattr(tracing, "recording") else None


def innermost(spans, points) -> list:
    """For each time in ``points`` the index of the innermost span of
    ``spans`` (objects with ``start_ns`` / ``end_ns``, nested as a call
    stack nests) that holds it; -1 where none does."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i].start_ns, -spans[i].end_ns))
    out = [-1] * len(points)
    stack, k = [], 0
    for q in sorted(range(len(points)), key=points.__getitem__):
        t = points[q]
        while k < len(order) and spans[order[k]].start_ns <= t:
            i = order[k]
            k += 1
            while stack and spans[stack[-1]].end_ns < spans[i].start_ns:
                stack.pop()
            stack.append(i)
        while stack and spans[stack[-1]].end_ns < t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


def attribute(events, spans, lo, hi) -> Attribution:
    """``events``: [(name, on_device, start_ns, end_ns, correlation id)] of
    one profile; ``spans`` as `innermost` takes them; [lo, hi] the job's
    host span.  Each device op's share of the busy time (its stretch that
    no earlier-starting op covers, so the shares add up to the union)
    goes to the innermost span holding its launch call, the host event of
    the same correlation id; each idle gap (`timeline.gaps`) to the
    innermost span covering its middle."""
    n = len(spans)
    dev = [(s, e, c) for _, d, s, e, c in events if d]
    host = [(nm, s, c) for nm, d, s, _, c in events if not d]
    launch_at = {c: s for nm, s, c in host if c}
    op_span = [-1] * len(dev)
    held = [i for i, (_, _, c) in enumerate(dev) if c in launch_at]
    for i, sp in zip(held, innermost(spans,
                                     [launch_at[dev[i][2]] for i in held])):
        op_span[i] = sp
    device_ns = [0] * n
    unattributed = 0
    t = lo
    for i in sorted(range(len(dev)), key=lambda i: dev[i][0]):
        s, e, _ = dev[i]
        share = max(0, min(e, hi) - max(s, t, lo))
        t = max(t, e)
        if op_span[i] >= 0:
            device_ns[op_span[i]] += share
        else:
            unattributed += share
    busy = timeline.union_s([(s, e) for s, e, _ in dev], lo, hi)
    idle_span = [0] * n
    outside = 0
    gaps = timeline.gaps([(s, e) for s, e, _ in dev], lo, hi)
    for (s, e), sp in zip(gaps, innermost(spans, [(s + e) / 2
                                                  for s, e in gaps])):
        if sp >= 0:
            idle_span[sp] += e - s
        else:
            outside += e - s
    launches, syncs = [0] * n, [0] * n
    calls = [(nm, s) for nm, s, _ in host if lo <= s <= hi]
    for (nm, _), sp in zip(calls, innermost(spans, [s for _, s in calls])):
        if sp >= 0:
            if LAUNCH in nm:
                launches[sp] += 1
            elif nm in SYNCS:
                syncs[sp] += 1
    return Attribution(busy_ns=busy, idle_ns=(hi - lo) - busy,
                       device_ns=device_ns, idle_span_ns=idle_span,
                       launches=launches, syncs=syncs,
                       unattributed_ns=unattributed, outside_ns=outside,
                       op_span=op_span)


def within(spans, name) -> list:
    """Per span: True where it or a span around it is named ``name``."""
    out = []
    for s in spans:
        out.append(s.name == name or (s.parent >= 0 and out[s.parent]))
    return out


def total(values, mask) -> float:
    return sum(v for v, m in zip(values, mask) if m)


def table(spans, a: Attribution) -> list:
    """Rows [name, spans, device s, idle s, launches, syncs] by span name,
    each span's own share (not its children's), largest first."""
    rows = {}
    for i, s in enumerate(spans):
        r = rows.setdefault(s.name, [s.name, 0, 0.0, 0.0, 0, 0])
        r[1] += 1
        r[2] += a.device_ns[i] / 1e9
        r[3] += a.idle_span_ns[i] / 1e9
        r[4] += a.launches[i]
        r[5] += a.syncs[i]
    rows = sorted(rows.values(), key=lambda r: -(r[2] + r[3]))
    return rows + [["(no span)", 0, a.unattributed_ns / 1e9,
                    a.outside_ns / 1e9, 0, 0]]


def _print_table(sp: SpanProfile):
    a = sp.attribution
    print(f"spans of the profiled job: {sp.window_ns / 1e9:.6f} s, device "
          f"busy {a.busy_ns / 1e9:.6f} s, idle {a.idle_ns / 1e9:.6f} s",
          file=sys.stderr)
    print(f"{'span':<32} {'spans':>6} {'device_s':>10} {'idle_s':>10} "
          f"{'launches':>9} {'syncs':>6}", file=sys.stderr)
    for name, k, d, i, n, y in table(sp.spans, a):
        print(f"{name:<32} {k:>6} {d:>10.6f} {i:>10.6f} {n:>9} {y:>6}",
              file=sys.stderr)
    shared = {}
    for name, s in zip(sp.op_names, a.op_span):
        for k in SHARED_KERNELS:
            if k in name:
                key = sp.spans[s].name if s >= 0 else "(no span)"
                by = shared.setdefault(k, {})
                by[key] = by.get(key, 0) + 1
    print(f"shared kernel names by span: {shared}", file=sys.stderr,
          flush=True)


def traced(run):
    """[[spans of job k]] of `TRACED_JOBS` more jobs, or None."""
    return run.cached("spans", lambda: _traced(run))


def _traced(run):
    tracing = recorder()
    if tracing is None:
        return None
    jobs = []
    for k in range(TRACED_JOBS):
        with tracing.recording(job=k) as spans:
            with tracing.span("job"):
                run.job.profiled()
        jobs.append(list(spans))
    traced_s = sum(j[0].end_ns - j[0].start_ns for j in jobs) / 1e9 / len(jobs)
    done = len(run.completed())
    if done:
        window_s = run.window_s / done
        print(f"tracing cost: {len(jobs)} traced jobs {traced_s:.6f} s mean "
              f"against the window's {window_s:.6f} s per job "
              f"({100 * (traced_s / window_s - 1):+.2f}%)", file=sys.stderr)
    return jobs


def span_seconds(jobs, *names) -> float:
    """Seconds per job in spans named ``names`` (host clock)."""
    return sum(s.end_ns - s.start_ns for j in jobs for s in j
               if s.name in names) / 1e9 / len(jobs)


def traced_profile(run):
    """`SpanProfile` of one more job, or None."""
    return run.cached("span_profile", lambda: _traced_profile(run))


def _traced_profile(run):
    tracing = recorder()
    if tracing is None:
        return None
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
        time.sleep(timeline.LEAD_S)
        with tracing.recording(job="profiled") as spans:
            lo = time.time_ns()
            with tracing.span("job"):
                run.job.profiled()
                torch.cuda.synchronize()
            hi = time.time_ns()
        time.sleep(timeline.LEAD_S)
    finally:
        result = _disable_profiler()
    events = [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
               e.end_ns(), e.correlation_id()) for e in result.events()]
    spans = list(spans)
    sp = SpanProfile(spans=spans,
                     op_names=[n for n, d, _, _, _ in events if d],
                     attribution=attribute(events, spans, lo, hi),
                     window_ns=hi - lo)
    _print_table(sp)
    return sp
