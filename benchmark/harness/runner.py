"""One run of one cell: set-up, the measured window, the metrics, the
check, and the result line.

The window is a closed loop with one job in flight: job j + 1 starts when
job j has returned, and jobs start until ``seconds`` have passed; the
window ends when the last of them returns, so every job in it is whole.
A job that raises counts as attempted and failed, and the loop goes on.

After the window the peak device memory is read; with ``trace`` the
per-layer metrics are read next (they may run more of the program: a
profiled job, kernel chains), then the program's state is freed and the
job kind's check runs the plain reference and compares."""

from __future__ import annotations

import math
import sys
import time
import traceback

#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "bundle_adjustment_tpu")


class Run:
    """What the job kinds and the metric readers share: the cell, the
    seed, the device, the set-up spans, the window's job records and a
    cache for measurements that several readers use."""

    def __init__(self, cell, seed, seconds, trace, device, t0):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t0 = t0
        self.spans = {}
        self.records = []
        self.window_s = None
        self.setup_s = None
        self.peak_bytes = None
        self.job = None
        self._cache = {}

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.on_card:
            import torch

            torch.cuda.synchronize(self.device)

    def cached(self, key, fn):
        """fn() once per run; later calls return its value."""
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def completed(self) -> list:
        """The window's jobs that returned an answer."""
        return [r for r in self.records if r["error"] is None]

    def profile(self):
        """One more job under torch.profiler (`timeline.profile`)."""
        from . import timeline

        return self.cached("profile", lambda: timeline.profile(
            self.job.profiled))


def worst(a: float, b: float) -> float:
    """The larger of two gaps; a gap that is not a number counts as
    infinite (``max`` would drop it)."""
    return math.inf if math.isnan(a) or math.isnan(b) else max(a, b)


def loaded_forbidden() -> list:
    """Modules in sys.modules whose top-level name is forbidden, compared
    whole (the port's package name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _window(run):
    job = run.job
    w0 = time.perf_counter()
    j = 0
    while time.perf_counter() - w0 < run.seconds:
        try:
            rec = job.run_one(j)
            rec["error"] = None
        except Exception as exc:  # noqa: BLE001 - one job's failure
            traceback.print_exc(file=sys.stderr)
            rec = {"error": f"{type(exc).__name__}: {exc}"}
        rec["index"] = j
        run.records.append(rec)
        j += 1
    run.window_s = time.perf_counter() - w0


def _read(metrics, run) -> dict:
    out = {}
    for m in metrics:
        if not run.on_card and m.source == "device_trace":
            continue        # a CPU rehearsal never writes a device number
        t = time.perf_counter()
        value = m.reader.read(run)
        print(f"read {m.name} {value!r} in {time.perf_counter() - t:.2f} s",
              file=sys.stderr, flush=True)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def execute(run) -> tuple:
    """Set up, measure, read, check.  Returns (result dict, exit code)."""
    import torch

    cell = run.cell
    run.job = cell.job.Job(run)
    run.job.setup()
    run.sync()
    if run.on_card:
        torch.cuda.reset_peak_memory_stats(run.device)
    run.setup_s = time.perf_counter() - run.t0
    _window(run)
    run.sync()
    run.peak_bytes = (torch.cuda.max_memory_allocated(run.device)
                      if run.on_card else 0)
    device = {"platform": "gpu" if run.on_card else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.on_card else "cpu"),
              "count": cell.chips if run.on_card else 1,
              "memory_peak_bytes": int(run.peak_bytes)}
    breakdown = None
    if run.trace:
        metrics = _read(cell.per_layer, run)
        if run.on_card:
            prof = run.profile()
            device["busy_s"] = prof.busy_s
            device["window_s"] = prof.window_s
            breakdown = {"device_ops": prof.device_ops,
                         "idle_gaps": prof.idle_gaps}
    else:
        metrics = _read(cell.end_to_end, run)
    run.job.release()
    numbers = run.job.check()
    failed = sum(r["error"] is not None for r in run.records)
    checks = {"jobs_failed": {"value": failed, "limit": 0}}
    for name, value in numbers.items():
        checks[name] = {"value": value, "limit": cell.limits[name]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}",
              file=sys.stderr)
        return None, 3
    result = {"correct": bool(correct), "attempted": len(run.records),
              "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, 0
