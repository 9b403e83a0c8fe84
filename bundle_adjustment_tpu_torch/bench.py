"""The port's benchmark: `bench.py`'s and `bench_schur.py`'s measurements on
one GPU, through the port's modules, under the same JSON keys.

    python bench_torch.py [P M V] [--mesh n]     (run_suite, main)
    python bench_schur_torch.py [nR M]           (schur_main)

Default run: 100,000 points / 500 images / 12 views (BASELINE config 4's
scale network, `synthetic.build_problem`, padded to 512 points), then
BASELINE config 5, 1,000,000 / 5,000 / 12, with ``full=False``:

  (a) time to converged: the f32 LM phase (`lm.run`, damping 1e-2 x0.2),
      then the mixed-precision refinement (`refine.converge`) to max|dx|
      <= 1e-6;
  (b) LM it/s at fixed CG work: `engine.lm_step` with cg_tol 0, 8 CG
      iterations, stall rule off;
  (c) the Schur matvec's GFLOP/s and GB/s: K1 (`kernels.schur_matvec_rows`)
      for the ``matvec_pallas_*`` keys, the plain `engine.schur_matvec`
      for ``matvec_xla_*``, K4 (`kernels.read_floor`) for the read floor;
  (d) every point's 3x3 covariance block: one float64 `cov_direct.cov_all`;
  (e) the n = 4096 f32 Cholesky: `torch.linalg.cholesky` and
      `tp.distributed_cholesky` on a one-rank communicator.

Where the port's record differs from `bench.py`'s, it says so in the record:

* ``refine_damping`` 0.0: the bench's 1e-7 contracts the weakest mode by
  ~2/3 per step on the port's exact operator, and its 15-step loop ends at
  max|dx| ~4e-4 at 100k (`refine.converge`); undamped converges in ~4.
* ``cov_dtype`` "float64": the f32 reduced system is indefinite at 100k.
* ``chip_matmul_tflops`` is the FP32 rate: TF32 stays off in the port.
* ``matvec_hbm_sol_fraction`` divides by an H100's 3.35 TB/s
  (`measure.HBM_BYTES_PER_S`); ``matvec_rows_read_gbps`` counts the 41
  rows K1 reads (`measure.matvec_rows_read`), the ``*_gbps`` keys the
  reference's 48-row padded count (`measure.matvec_cost`).
* Each timed phase runs ``repeats`` times in the one process (3 by default;
  at ``full=False`` (a) and (d) run once): a key holds the median and
  ``spread`` holds {key: [min, max]}.
* Nothing falls back.  The suite runs on ``cuda:0`` through the CUDA
  kernels, or on the CPU (the kernels' plain versions) only when asked
  (``device="cpu"``; ``BENCH_CPU=1`` for `main`).  A failed phase is
  recorded as ``<phase>_error`` and `main` exits non-zero.

Timing: host clock around work that ends in a host read or a
``torch.cuda.synchronize``; the matvec chains between CUDA events (K back
to back for K = 4 and 36, (T36 - T4) / 32 per call: the launch gaps of a
chain's start cancel).  torch.profiler times no key.  What `bench.py` needs
for a TPU and not here: jit closures, ``bigargs``, the compilation cache
(the kernels build once with nvcc: ``compile_s.kernel_build_s``).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager

import numpy as np
import torch

from . import convert, kernel_build, measure, synthetic
from .parallel import (cov_direct, engine, hilo, kernels, lm, multihost, rcs,
                       refine, sharding, spmd_fm, tp)
from .solver.adjustment import resolve_device

#: the Java reference's generous sustained rate: a dense (3P)^3 / 6 LDL^T
#: per iteration at this rate is `bench.py`'s baseline (see its docstring)
JAVA_FLOPS_PER_S = 5e10
REPEATS = 3
REFINE_DAMPING = 0.0
REFINE_TOL = 1e-6
REFINE_MAX_STEPS = 15          # bench.py:697
LM_DAMPING = 1e-2              # the LM phase's first damping (bench.py:667)
HEALTH_N, HEALTH_MATMULS = 2048, 16
HEALTH_LAUNCHES = 6
FIXED_SHORT, FIXED_LONG = 4, 20      # fixed-cg8 steps of the two runs
CHAIN_SHORT, CHAIN_LONG = 4, 36      # matvec launches of the two chains
CHAIN_RUNS = 5                       # chains of each length
CHOL_N, CHOL_RANK, CHOL_COPIES = 4096, 256, 4
TP_BLOCK = 512                       # bench.py:1020
COV_CHECK_RTOL = 1e-8     # the staged run's blocks against cov_all's
MESH_DEFAULT = (20_000, 100, 8)      # bench.py:1126
MESH_DAMPING = 1e-3
MESH_CG = (8, 40)
MESH_STEPS = 6
MESH_WAIT_S = 900.0
CONFIG5 = (1_000_000, 5_000)
CONFIG5_BUDGET_S = 2100
#: the config-5 keys of the final record (bench.py:1195-1201, then the
#: port's own)
CONFIG5_KEYS = ("lm_it_per_s_fixed_cg8_pallas", "lm_it_per_s_fixed_cg8",
                "time_to_converged_s", "converged_max_dx",
                "lm_iterations_to_converge", "matvec_pallas_gbps",
                "matvec_hbm_sol_fraction", "cov_point_blocks_per_s",
                "cov_all_points_s", "first_compile_s", "compile_s",
                "matvec_rows_read_gbps", "cov_peak_gb", "spread", "launches")
COV_STAGES = ("linearise", "assemble_base", "corrections", "inverse",
              "recovery")
COV_PATH = ("cov_direct.cov_all: float64 dense S (per-image sums, pair-"
            "block corrections), Cholesky inverse, per-point block gathers")
COV_NOTE = ("no compilation cache: cov_compile_s is the first call (cuBLAS "
            "and cuSOLVER handles, allocator growth), cov_all_points_s the "
            "median warm call")


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------

def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_s(fn, dev):
    """(seconds, fn()) on the host clock; the device is synchronised before
    and after, so the time holds fn's device work."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return time.perf_counter() - t0, out


def chain_s(fn, k: int, dev) -> float:
    """Seconds of ``k`` back-to-back fn() calls: between two CUDA events on
    a card, on the host clock on the CPU (whose ops return when done)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        return time.perf_counter() - t0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(k):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / 1e3


def per_call_s(fn, dev, runs: int = CHAIN_RUNS) -> float:
    """Seconds per fn() call from the difference of ``runs`` chains of
    `CHAIN_LONG` and of `CHAIN_SHORT` calls (`bench.py`'s rule: whatever a
    chain pays once, its start, cancels)."""
    fn()
    _sync(dev)
    t_short = sum(chain_s(fn, CHAIN_SHORT, dev) for _ in range(runs))
    t_long = sum(chain_s(fn, CHAIN_LONG, dev) for _ in range(runs))
    dt = (t_long - t_short) / (runs * (CHAIN_LONG - CHAIN_SHORT))
    return dt if dt > 0 else t_long / (runs * CHAIN_LONG)


def keep(out: dict, spread: dict, key: str, values):
    """out[key] = the median of ``values``; spread[key] = [min, max] where
    there is more than one."""
    values = [float(v) for v in values]
    out[key] = statistics.median(values)
    if len(values) > 1:
        spread[key] = [min(values), max(values)]


def card_line(dev) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card (its line),
    "cpu" on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    lines = r.stdout.strip().splitlines()
    idx = dev.index or 0
    if r.returncode != 0 or len(lines) <= idx:
        return f"nvidia-smi failed: {r.stderr.strip()[:200]}"
    return lines[idx].strip()


def device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def java_iter_per_s(num_points: int) -> float:
    """LM iterations per second of the dense Java reference at P points:
    one (3P)^3 / 6 factorisation per iteration at `JAVA_FLOPS_PER_S`."""
    return 1.0 / (((3 * num_points) ** 3 / 6) / JAVA_FLOPS_PER_S)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def health(dev, repeats):
    """`bench.py`'s sentinels: 16 chained 2048^2 f32 matmuls (TF32 off:
    the FP32 rate), and a trivial launch's latency over 6 dependent
    launches and one host read."""
    a = torch.ones((HEALTH_N, HEALTH_N), dtype=torch.float32, device=dev)

    def matmuls(k):
        o = a * (1.0 + 1e-9 * k)
        for _ in range(HEALTH_MATMULS):
            o = o @ a
            o = o * (1.0 / torch.sqrt(o[0, 0].abs() + 1.0))
        return float(o[0, 0])

    def launches():
        z = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(HEALTH_LAUNCHES):
            z = z + 1.0
        return float(z)

    matmuls(0)
    launches()
    flops = HEALTH_MATMULS * 2 * HEALTH_N ** 3
    tflops, lat_ms = [], []
    for k in range(repeats):
        t0 = time.perf_counter()
        matmuls(k + 1)
        tflops.append(flops / (time.perf_counter() - t0) / 1e12)
        t0 = time.perf_counter()
        launches()
        lat_ms.append((time.perf_counter() - t0) / HEALTH_LAUNCHES * 1e3)
    return tflops, lat_ms


def lm_first_step(fv, state0, spec, use_kernels):
    """The first step of the LM phase (`lm.run`'s settings); returns
    max|dx| as a float (a host read)."""
    dxp, dxc, dxg, _, _ = engine.lm_step(
        fv, state0, spec, LM_DAMPING, cg_tol=1e-4, cg_maxiter=100,
        use_kernels=use_kernels, couple_global=True, stall_limit=8)
    a = lm.step_scale(LM_DAMPING)
    return float(rcs.apply_step(state0, a * dxp, a * dxc, a * dxg)[1])


def converge_runs(fv, refiner, state0, spec, use_kernels, damping, repeats):
    """(a): ``repeats`` runs from ``state0`` of the LM phase and the
    refinement.  Returns [(LMPhase state, LMPhase, HiLoState,
    Convergence)]; raises where a run does not reach `REFINE_TOL`."""
    runs = []
    for _ in range(repeats):
        st, ph = lm.run(fv, state0, spec, damping=LM_DAMPING, max_steps=60,
                        use_kernels=use_kernels)
        s, rec = refine.converge(refiner, (st, ph), tolerance=REFINE_TOL,
                                 max_steps=REFINE_MAX_STEPS, damping=damping)
        log(f"f32 phase: {ph.steps} its in {ph.seconds:.3f}s, max|dx| "
            f"{ph.max_dx:.2e}; refinement (damping {damping:g}): "
            f"{rec.refine_steps} its in {rec.refine_seconds:.3f}s, max|dx| "
            + ", ".join(f"{x:.2e}" for x in rec.max_dx)
            + f"; CG {rec.cg_iterations}")
        if not rec.converged:
            raise RuntimeError(
                f"the refinement at damping {damping:g} did not reach "
                f"max|dx| <= {REFINE_TOL} in {REFINE_MAX_STEPS} steps "
                f"(max|dx| {rec.max_dx})")
        runs.append((st, ph, s, rec))
    return runs


def fixed_cg8_rates(fv, state, spec, use_kernels, repeats):
    """(b): LM it/s at fixed CG work, each repeat from `FIXED_LONG` minus
    `FIXED_SHORT` steps (every step ends in a host read of max|dx|)."""
    def step(s):
        dxp, dxc, dxg, _, _ = engine.lm_step(
            fv, s, spec, 1e-6, cg_tol=0.0, cg_maxiter=8, stall_limit=9,
            use_kernels=use_kernels)
        s, mdx = rcs.apply_step(s, dxp, dxc, dxg)
        float(mdx)
        return s

    def run(s, n):
        t0 = time.perf_counter()
        for _ in range(n):
            s = step(s)
        return time.perf_counter() - t0, s

    s = step(state)
    rates = []
    for _ in range(repeats):
        t_short, s = run(s, FIXED_SHORT)
        t_long, s = run(s, FIXED_LONG)
        dt = (t_long - t_short) / (FIXED_LONG - FIXED_SHORT)
        rates.append(1.0 / (dt if dt > 0 else t_long / FIXED_LONG))
    return rates


def matvec_times(fv, state, spec, dev, use_kernels, full, repeats):
    """(c): seconds per matvec call, by route: "pallas" (K1 on the lean
    packed rows), "read_floor" (K4 on them) and "xla" (the plain
    `engine.schur_matvec`), the last two at ``full`` only; each a list
    over the repeats.  Also the plain prepare's first-call seconds and, on
    a card, K1's ms back to back (`measure.time_ms`, phase 6 of
    `chip_smoke.py`'s rule)."""
    t_prep, (b, rc, rg, _) = wall_s(lambda: engine.prepare(
        fv, state, spec, 1e-6, couple_global=True), dev)
    times, extra = {}, {"prepare_xla_compile_s": t_prep}
    rc, rg = rc.contiguous(), rg.contiguous()
    if use_kernels:
        pp = kernels.pack_fm(b, fv, lean_only=True)
        ec, eg = b.extra_c.contiguous(), b.extra_g.contiguous()
        xin = torch.zeros((8, 128), dtype=torch.float32, device=dev)

        def k1():
            return kernels.schur_matvec_rows(pp, ec, eg, rc, rg)

        times["pallas"] = [per_call_s(k1, dev) for _ in range(repeats)]
        extra["k1_back_to_back_ms"] = measure.time_ms(k1, reps=50)
        if full:
            times["read_floor"] = [
                per_call_s(lambda: kernels.read_floor(pp, xin), dev)
                for _ in range(repeats)]
        del pp
    if full:
        times["xla"] = [per_call_s(lambda: engine.schur_matvec(
            fv, b, rc, rg), dev) for _ in range(repeats)]
    return times, extra


def cov_stages(fmp, state, spec, dev):
    """`cov_direct.cov_all`'s calls one by one, timed (CUDA events on a
    card, the host clock on the CPU).  Returns ({stage: s}, blocks)."""
    marks = []

    def mark():
        if dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)
        else:
            marks.append(time.perf_counter())

    _sync(dev)
    mark()
    b = engine.materialize_global_rows(
        fmp, engine.linearize(fmp, state, spec, 0.0))
    mark()
    S = cov_direct.assemble_reduced_base(fmp, b)
    mark()
    S = cov_direct.assemble_reduced_corrections(fmp, b, S)
    mark()
    Q = cov_direct.reduced_inverse(S)
    del S
    mark()
    blocks = cov_direct.point_covariance_dense(fmp, b, Q)
    mark()
    _sync(dev)
    if dev.type == "cuda":
        sec = [a.elapsed_time(c) / 1e3 for a, c in zip(marks, marks[1:])]
    else:
        sec = [c - a for a, c in zip(marks, marks[1:])]
    return dict(zip(COV_STAGES, sec)), blocks


def covariance(prob, state64, spec, dev, repeats):
    """(d): one cold and ``repeats`` warm float64 `cov_all` calls and the
    stage split.  Returns (cold s, [warm s], {stage: s}, P, peak GB or
    None); raises where the blocks are not finite or the staged run's
    differ from cov_all's."""
    fmp = engine.fm_problem(refine.upcast_problem(prob))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def call():
        return cov_direct.cov_all(fmp, state64, spec)

    cold, blocks = wall_s(call, dev)
    warm = []
    for _ in range(repeats):
        t, blocks = wall_s(call, dev)
        warm.append(t)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else None
    stages, staged = cov_stages(fmp, state64, spec, dev)
    scale = float(blocks.abs().max())
    err = float((staged - blocks).abs().max()) / scale
    if not (torch.isfinite(blocks).all() and err <= COV_CHECK_RTOL):
        raise RuntimeError(f"cov_all's blocks: finite "
                           f"{bool(torch.isfinite(blocks).all())}, staged "
                           f"run off by {err:.2e} of the largest entry")
    return cold, warm, stages, fmp.num_points, peak


@contextmanager
def one_rank_comm(dev):
    """A `sharding.Comm` of world size 1 in this process (NCCL on a card,
    gloo on the CPU), its process group destroyed on exit."""
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a default process group exists already: the "
                           "one-rank Cholesky needs its own")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield sharding.Comm(None, dev)
    finally:
        dist.destroy_process_group()


def cholesky_times(dev, repeats):
    """(e): seconds per factorisation of the n = 4096 f32 SPD matrix of
    `bench.py` (numpy seed 7), `CHOL_COPIES` scaled copies per call (each
    call's matrix shifted, as `bench.py`'s), one warm call, then one call
    per repeat, for `torch.linalg.cholesky` and `tp.distributed_cholesky`
    (block 512, one rank).  Each a list over the repeats."""
    rng = np.random.default_rng(7)
    A = rng.normal(0, 1, (CHOL_N, CHOL_RANK)).astype(np.float32)
    S = torch.as_tensor(A @ A.T + CHOL_N * np.eye(CHOL_N, dtype=np.float32),
                        device=dev)

    def copies(fac):
        def f(M):
            acc = 0.0
            for k in range(CHOL_COPIES):
                L = fac(M * (1.0 + 1e-6 * (k + 1)))
                acc = acc + L[0, 0] + L[-1, -1]
            return float(acc)
        return f

    def measure_(f):
        f(S)
        return [wall_s(lambda: f(S + (k + 1.0)), dev)[0] / CHOL_COPIES
                for k in range(repeats)]

    xla = measure_(copies(torch.linalg.cholesky))
    with one_rank_comm(dev) as comm:
        def dist_rows(M):
            return tp.distributed_cholesky(M, comm, block=TP_BLOCK).rows

        tpc = measure_(copies(dist_rows))
    return xla, tpc


# ---------------------------------------------------------------------------
# the suite
# ---------------------------------------------------------------------------

def _phase(out, name, emit, fn):
    """Run one phase that later phases do not need; a failure is recorded
    as ``<name>_error`` (traceback on stderr) and the suite goes on."""
    try:
        fn()
    except Exception as exc:  # the boundary of a phase: record, go on
        traceback.print_exc(file=sys.stderr)
        out[f"{name}_error"] = f"{type(exc).__name__}: {exc}"[:300]
    if emit is not None:
        emit(dict(out))


def run_suite(num_points, num_images, views, full=True, emit=None,
              device=None, refine_damping=REFINE_DAMPING, repeats=REPEATS):
    """All measurements on one configuration; returns the record (dict).

    ``device``: None takes ``cuda:0`` and raises without a card; "cpu"
    runs the plain path (the kernels' wrappers take their plain versions
    on CPU tensors, and the keys are then those of `bench.py` off the
    TPU).  ``full=False`` (config 5): K1 alone on the lean rows in (c), no
    Cholesky, (a) and (d) once.  ``emit(partial)`` after each phase.
    Phases (a) and (b) and the build raise on failure; (c), (d), (e) and
    the sentinels record ``<phase>_error``."""
    dev = resolve_device("cuda:0" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    on_card = dev.type == "cuda"
    once = repeats if full else 1
    out = {"device": device_name(dev), "card": card_line(dev),
           "refine_damping": refine_damping, "cov_dtype": "float64"}
    spread, compiles, launches = {}, {}, {}
    out["spread"] = spread

    def sentinels():
        tf, lat = health(dev, repeats)
        keep(out, spread, "chip_matmul_tflops", tf)
        keep(out, spread, "relay_latency_ms", lat)
        log(f"health: {out['chip_matmul_tflops']:.1f} TFLOP/s (FP32), "
            f"{out['relay_latency_ms']:.4f} ms per launch; {out['card']}")

    _phase(out, "chip_health", None, sentinels)

    # ---- build -------------------------------------------------------------
    if on_card:
        compiles["kernel_build_s"] = kernel_build.build().seconds
        kernel_build.library()
    log(f"building problem: P={num_points} M={num_images} "
        f"N_obs={num_points * views}")
    t0 = time.perf_counter()
    prob_h, state_h, spec = synthetic.build_problem(num_points, num_images,
                                                    views, seed=0)
    prob = convert.problem_to_torch(prob_h, dev, torch.float32)
    state0 = convert.state_to_torch(state_h, dev, torch.float32)
    fmp = engine.fm_problem(prob)
    G = 3 + spec.num_coefficients
    fv = engine.to_view_major(fmp, kernels.choose_pb(
        fmp.num_points, fmp.views, G)) if on_card else fmp
    del fmp
    _sync(dev)
    compiles["build_s"] = time.perf_counter() - t0
    log(f"build: {compiles['build_s']:.2f}s (P={fv.num_points} with the "
        f"dummy points); digest {synthetic.digest(prob_h, state_h)}")
    del prob_h, state_h
    N = fv.num_points * fv.views

    # ---- (a) time to converged ----------------------------------------------
    t, mdx = wall_s(lambda: lm_first_step(fv, state0, spec, on_card), dev)
    compiles["lm_compile_s"] = out["first_compile_s"] = t
    log(f"first LM step (cold): {t:.3f}s, max|dx| {mdx:.2e}")

    def refine_first():
        r = refine.Refiner(prob, spec, use_kernels=on_card)
        r.step(hilo.from_f32(state0), damping=refine_damping, cg_tol=1e-12,
               cg_maxiter=800, stall_limit=300)
        return r

    t, refiner = wall_s(refine_first, dev)
    compiles["refine_compile_s"] = out["refine_compile_s"] = t
    log(f"refiner and its first step (cold): {t:.3f}s")
    kernels.reset_launch_counts()
    runs = converge_runs(fv, refiner, state0, spec, on_card, refine_damping,
                         once)
    launches["converge"] = kernels.launch_counts()
    keep(out, spread, "time_to_converged_s",
         [ph.seconds + rec.refine_seconds for _, ph, _, rec in runs])
    state, ph, s_ref, rec = runs[-1]
    out["converged_max_dx"] = rec.max_dx[-1]
    out["lm_iterations_to_converge"] = ph.steps + rec.refine_steps
    state64 = hilo.to_f64(s_ref)
    del refiner, runs, s_ref

    # ---- (b) LM it/s at fixed CG work ---------------------------------------
    kernels.reset_launch_counts()
    rates = fixed_cg8_rates(fv, state, spec, on_card, repeats)
    launches["fixed_cg8"] = kernels.launch_counts()
    key = "lm_it_per_s_fixed_cg8_pallas" if on_card \
        else "lm_it_per_s_fixed_cg8"
    keep(out, spread, key, rates)
    log(f"steady state (cg=8 fixed{', kernels' if on_card else ''}): "
        f"{out[key]:.3f} it/s")
    if emit is not None:
        emit(dict(out))

    # ---- (c) the Schur matvec -----------------------------------------------
    def roofline():
        flops, fbytes = measure.matvec_cost(N, G, views)
        rows = measure.matvec_rows_read(N, G)
        kernels.reset_launch_counts()
        times, extra = matvec_times(fv, state, spec, dev, on_card, full,
                                    repeats)
        launches["matvec"] = kernels.launch_counts()
        compiles["prepare_xla_compile_s"] = extra["prepare_xla_compile_s"]
        ms = out["matvec_ms"] = {}
        for route, key in (("xla", "matvec_xla"), ("pallas", "matvec_pallas")):
            if route in times:
                keep(out, spread, f"{key}_gflops",
                     [flops / t / 1e9 for t in times[route]])
                keep(out, spread, f"{key}_gbps",
                     [fbytes / t / 1e9 for t in times[route]])
                ms[route] = statistics.median(times[route]) * 1e3
        if "read_floor" in times:
            keep(out, spread, "matvec_read_floor_gbps",
                 [fbytes / t / 1e9 for t in times["read_floor"]])
            keep(out, spread, "matvec_vs_read_floor",
                 [f / k for f, k in zip(times["read_floor"],
                                         times["pallas"])])
            ms["read_floor"] = statistics.median(times["read_floor"]) * 1e3
        if "k1_back_to_back_ms" in extra:
            ms["pallas_back_to_back"] = extra["k1_back_to_back_ms"]
        best = times.get("pallas") or times.get("xla")
        if best:
            keep(out, spread, "matvec_hbm_sol_fraction",
                 [fbytes / t / measure.HBM_BYTES_PER_S for t in best])
            keep(out, spread, "matvec_rows_read_gbps",
                 [rows / t / 1e9 for t in best])
        log(f"matvec: xla {out.get('matvec_xla_gbps', '-')} GB/s, kernel "
            f"{out.get('matvec_pallas_gbps', '-')} GB/s, read floor "
            f"{out.get('matvec_read_floor_gbps', '-')} GB/s (padded count); "
            f"ms {ms}")

    _phase(out, "matvec", emit, roofline)
    out["compile_s"] = compiles
    out["launches"] = launches
    del fv
    if on_card:
        torch.cuda.empty_cache()

    # ---- (d) covariance -----------------------------------------------------
    def cov():
        out["cov_path"] = COV_PATH
        out["cov_cache_note"] = COV_NOTE
        cold, warm, stages, P, peak = covariance(prob, state64, spec, dev,
                                                 once)
        compiles["cov_compile_s"] = cold
        out["cov_stage_s"] = stages
        keep(out, spread, "cov_all_points_s", warm)
        keep(out, spread, "cov_point_blocks_per_s", [P / t for t in warm])
        if peak is not None:
            out["cov_peak_gb"] = peak
        log(f"covariance: all {P} point blocks in "
            f"{out['cov_all_points_s']:.4f}s (float64; cold {cold:.3f}s); "
            "stages " + ", ".join(f"{n} {s * 1e3:.1f} ms"
                                  for n, s in stages.items()))

    _phase(out, "cov", emit, cov)
    if not full:
        return out

    # ---- (e) the n = 4096 Cholesky ------------------------------------------
    def cholesky():
        flops = CHOL_N ** 3 / 3
        xla, tpc = cholesky_times(dev, repeats)
        keep(out, spread, "xla_cholesky_gflops",
             [flops / t / 1e9 for t in xla])
        keep(out, spread, "tp_cholesky_gflops",
             [flops / t / 1e9 for t in tpc])
        out["tp_cholesky_n"] = CHOL_N
        log(f"cholesky n={CHOL_N}: torch.linalg "
            f"{out['xla_cholesky_gflops']:.1f} GFLOP/s, tp (one rank, block "
            f"{TP_BLOCK}) {out['tp_cholesky_gflops']:.1f} GFLOP/s")

    _phase(out, "tp_cholesky", emit, cholesky)
    return out


# ---------------------------------------------------------------------------
# the sharded step (--mesh n)
# ---------------------------------------------------------------------------

def mesh_rank(comm, num_points, num_images, views):
    """One rank of `run_mesh_suite`: the point-sharded fixed-CG step at 8
    and 40 CG iterations, each timed as `bench.py`'s ``_time_chain`` (6
    steps less 1; every step's state feeds the next, a host read ends
    each run).  Returns {"compile_s", 8: s, 40: s, "N", "G"}."""
    prob_h, state_h, spec = synthetic.build_problem(num_points, num_images,
                                                    views, seed=0)
    problem = convert.problem_to_torch(prob_h, "cpu", torch.float32)
    state = convert.state_to_torch(state_h, "cpu", torch.float32)
    problem, state, _ = spmd_fm.pad_for_mesh(problem, state, comm)
    res = {"N": int(problem.obs_point.shape[0]),
           "G": 3 + spec.num_coefficients}
    for cg in MESH_CG:
        t0 = time.perf_counter()
        step, args0 = spmd_fm.make_spmd_fm_lm_step(
            problem, state, spec, comm, damping=MESH_DAMPING, cg_tol=1e-30,
            cg_maxiter=cg, stall_limit=10 ** 6)
        float(step(*args0)[1])
        if cg == MESH_CG[0]:
            res["compile_s"] = time.perf_counter() - t0

        def run(n):
            a = args0
            t = time.perf_counter()
            for _ in range(n):
                o = step(*a)
                a = o[0]
            float(o[1])
            return time.perf_counter() - t, o

        t1, _ = run(1)
        tn, o = run(MESH_STEPS)
        if int(o[3]) != cg:
            raise RuntimeError(f"the sharded step ran {int(o[3])} CG "
                               f"iterations, not {cg}")
        dt = (tn - t1) / (MESH_STEPS - 1)
        res[cg] = dt if dt > 0 else tn / MESH_STEPS
    return res


def run_mesh_suite(n_mesh, num_points, num_images, views, device=None):
    """`bench.py --mesh n`: the point-sharded step (`spmd_fm`) on n ranks
    (`multihost.run_ranks`): n gloo ranks on ``cuda:0`` (a semantics run on
    one card, not a scaling figure) or, with device "cpu", on the CPU."""
    dev = resolve_device("cuda:0" if device is None else device)
    rank_dev = "cuda:0" if dev.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory() as work:
        res = multihost.run_ranks(
            mesh_rank, n_mesh, args=(num_points, num_images, views),
            workdir=work, device=rank_dev, backend="gloo", wait=MESH_WAIT_S)
    r = res[0]
    per_mv = (r[MESH_CG[1]] - r[MESH_CG[0]]) / (MESH_CG[1] - MESH_CG[0])
    fbytes = measure.matvec_cost(r["N"], r["G"], views)[1]
    out = {"mesh_devices": n_mesh,
           "mesh_platform": f"{rank_dev} x {n_mesh}, gloo",
           "device": device_name(dev), "card": card_line(dev),
           "mesh_compile_s": r["compile_s"],
           "mesh_lm_it_per_s_fixed_cg8": 1.0 / r[MESH_CG[0]],
           "mesh_matvec_ms": per_mv * 1e3,
           "mesh_matvec_agg_gbps": fbytes / per_mv / 1e9}
    log(f"mesh ({out['mesh_platform']}): "
        f"{out['mesh_lm_it_per_s_fixed_cg8']:.3f} it/s cg8, matvec "
        f"{out['mesh_matvec_ms']:.3f} ms")
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def failed(rec) -> bool:
    """Whether a record holds an ``*_error`` or ``error`` key, at any
    depth."""
    if not isinstance(rec, dict):
        return False
    return any(k == "error" or k.endswith("_error") or failed(v)
               for k, v in rec.items())


def _device_from_env():
    return "cpu" if os.environ.get("BENCH_CPU") else "cuda:0"


def main(argv=None) -> int:
    """`bench.py`'s command line: ``[P M V] [--mesh n]``; provisional JSON
    lines after the phases, the record last.  Returns the exit code: 1
    where a phase failed (the record says which), else 0."""
    argv = list(sys.argv[1:] if argv is None else argv)
    mesh_n = 0
    if "--mesh" in argv:
        i = argv.index("--mesh")
        mesh_n = int(argv[i + 1])
        del argv[i:i + 2]
    device = _device_from_env()
    num_points = int(float(argv[0])) if argv else 100_000
    num_images = int(argv[1]) if len(argv) > 1 else 500
    views = int(argv[2]) if len(argv) > 2 else 12
    with_config5 = not argv
    t_start = time.time()

    if mesh_n:
        if not argv:
            num_points, num_images, views = MESH_DEFAULT
        out = run_mesh_suite(mesh_n, num_points, num_images, views, device)
        rate = out["mesh_lm_it_per_s_fixed_cg8"]
        result = {"metric": f"mesh{mesh_n}_lm_iterations_per_s_{num_points}"
                            f"pts_fixed_cg8",
                  "value": rate, "unit": "lm_iter/s",
                  "vs_baseline": rate / java_iter_per_s(num_points),
                  "total_wall_s": time.time() - t_start, **out}
        print(json.dumps(result), flush=True)
        return 0

    java = java_iter_per_s(num_points)
    metric = f"lm_iterations_per_s_{num_points}pts_{num_images}img_fixed_cg8"
    last = {}

    def record(partial, label):
        headline = partial.get("lm_it_per_s_fixed_cg8_pallas",
                               partial.get("lm_it_per_s_fixed_cg8"))
        rec = {"metric": metric, "value": headline, "unit": "lm_iter/s",
               "vs_baseline": None if headline is None else headline / java,
               "phase": label}
        rec.update(partial)
        return rec

    def emit(partial, label="provisional"):
        last.clear()
        last.update(partial)
        rec = record(partial, label)
        if rec["value"] is not None:
            print(json.dumps(rec), flush=True)

    try:
        out = run_suite(num_points, num_images, views, full=True, emit=emit,
                        device=device)
    except Exception as exc:  # the boundary: print what there is, fail
        traceback.print_exc(file=sys.stderr)
        rec = record(dict(last), "failed")
        rec["error"] = f"{type(exc).__name__}: {exc}"[:300]
        rec["total_wall_s"] = time.time() - t_start
        print(json.dumps(rec), flush=True)
        return 1

    budget = int(os.environ.get("BENCH_CONFIG5_BUDGET_S", CONFIG5_BUDGET_S))
    if with_config5 and time.time() - t_start > budget:
        out["config5_1m_points"] = {
            "skipped": f"over budget ({time.time() - t_start:.0f}s elapsed, "
                       f"BENCH_CONFIG5_BUDGET_S={budget})"}
        with_config5 = False
    if with_config5:
        emit(dict(out), label="pre_config5")
        last5 = {}

        def emit5(partial):
            last5.clear()
            last5.update(partial)
            emit({**out, "config5_1m_points": partial},
                 label="config5_partial")

        try:
            c5 = run_suite(*CONFIG5, views, full=False, emit=emit5,
                           device=device)
            out["config5_1m_points"] = {k: c5[k] for k in CONFIG5_KEYS
                                        if k in c5}
            for k in c5:
                if k.endswith("_error"):
                    out["config5_1m_points"][k] = c5[k]
        except Exception as exc:  # keep the phases that completed
            traceback.print_exc(file=sys.stderr)
            out["config5_1m_points"] = {
                **last5, "error": f"{type(exc).__name__}: {exc}"[:300]}

    rec = record(out, "complete")
    rec["total_wall_s"] = time.time() - t_start
    print(json.dumps(rec), flush=True)
    return 1 if failed(out) else 0


# ---------------------------------------------------------------------------
# bench_schur: the batched EO-block Schur complement
# ---------------------------------------------------------------------------

SCHUR_REPS = 10
#: the Java reference's per-image scalar loops, credited with 2 GFLOP/s
#: (`bench_schur.py`)
SCHUR_JAVA_GFLOPS = 2.0


def schur_system(nR, M, dtype, device, seed=0):
    """`bench_schur.py`'s synthetic SPD-ish bordered system: N = A A^T / 1e4
    + 10 I (A [T, T] standard normal from numpy ``seed``, T = nR + 6M, the
    product on ``device``), n [T], and the EO columns nR.. as [M, 6].
    Returns (N, n, col_eo)."""
    rng = np.random.default_rng(seed)
    T = nR + 6 * M
    A = torch.as_tensor(rng.normal(size=(T, T)).astype(np.float32),
                        device=device).to(dtype) * 0.01
    N = A @ A.T + 10.0 * torch.eye(T, dtype=dtype, device=device)
    del A
    n = torch.as_tensor(rng.normal(size=T).astype(np.float32),
                        device=device).to(dtype)
    col_eo = (nR + torch.arange(6 * M, device=device)).reshape(M, 6)
    return N, n, col_eo


def schur_reduce(N, n, col_eo, nR):
    """`ops.schur.reduce_eo` keeping the leading nR columns."""
    from .ops.schur import reduce_eo

    return reduce_eo(N, n, col_eo, torch.arange(nR, device=N.device))


def schur_flops(nR, M) -> float:
    """`bench_schur.py`'s count: W = N12 blockdiag(inv N22) (nR M 36 x 2),
    S -= W N12^T (nR^2 6M x 2), the 6x6 inverses (~M 216 x 2)."""
    return 2 * nR * nR * 6 * M + 2 * nR * M * 36 + 2 * M * 216


def schur_main(argv=None) -> int:
    """`bench_schur.py`'s command line ``[nR M]``: f32 `reduce_eo` on
    ``cuda:0`` (the CPU with ``BENCH_CPU=1``); one JSON line."""
    argv = list(sys.argv[1:] if argv is None else argv)
    nR = int(argv[0]) if argv else 4096
    M = int(argv[1]) if len(argv) > 1 else 1024
    dev = resolve_device(_device_from_env())
    N, n, col_eo = schur_system(nR, M, torch.float32, dev)
    f = schur_reduce(N, n, col_eo, nR)
    _sync(dev)
    del f

    def reps():
        for _ in range(SCHUR_REPS):
            out = schur_reduce(N, n, col_eo, nR)
        return out

    dt = wall_s(reps, dev)[0] / SCHUR_REPS
    gflops = schur_flops(nR, M) / dt / 1e9
    log(f"reduce_eo nR={nR} M={M}: {dt * 1e3:.2f} ms -> {gflops:.0f} "
        f"GFLOP/s ({card_line(dev)})")
    print(json.dumps({"metric": f"schur_gflops_per_chip_nr{nR}_m{M}",
                      "value": gflops, "unit": "GFLOP/s",
                      "vs_baseline": gflops / SCHUR_JAVA_GFLOPS,
                      "device": device_name(dev)}), flush=True)
    return 0
