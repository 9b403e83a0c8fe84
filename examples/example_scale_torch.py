"""Scale-path example of the PyTorch port: a synthetic network solved,
refined and given its posterior covariance on one GPU.

The port's counterpart of examples/example_scale.py, on the same story: a
network the dense solver cannot touch (20,000 points / 100 images by
default), solved by the point-eliminated implicit-Schur engine in f32
(`parallel.solver.solve`, stopped at max|dx| <= 1e-3: the f32 floor lies
above the dtype's default tolerance), refined to max|dx| <= 1e-6
(`parallel.refine.converge`, undamped: the bench's damping 1e-7 stalls the
weakest mode), and every point's 3x3 cofactor block from the dense
reduced system in f64 (`parallel.cov_direct.cov_all`; the f32 reduced
system is indefinite at scale).

Then the same network with uneven visibility (`synthetic.thin_views`:
every 10th point keeps all its views, the others half of them) in file
order, the block-layout engine's route: the f32 `solve`, then the same
refinement to max|dx| <= 1e-6 on that order, never padded, and the
covariance blocks of a few points on demand (`parallel.covariance`;
`cov_direct` takes the point-major layout only).

Runs on the GPU unless given --cpu.  Usage:

    python examples/example_scale_torch.py [--cpu] [points images views]

The last line of the output is a JSON object with each part's sigma0,
steps and max|dx|.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bundle_adjustment_tpu_torch import convert, synthetic  # noqa: E402
from bundle_adjustment_tpu_torch.parallel import (  # noqa: E402
    cov_direct, covariance, engine, hilo, lm, rcs, refine, solver)

F32_STOP = 1e-3      # max|dx| at which the f32 solve hands over
REFINE_TOL = 1e-6    # max|dx| of the refined state
THIN_EVERY = 10      # every 10th point of the file-order network keeps
                     # all its views


def dof_of(problem) -> int:
    """Observations less unknowns (fixed-coordinate datum: no defect)."""
    n_obs = 2 * int((problem.obs_weight[:, 0, 0] > 0).sum())
    u = int(problem.free_point.sum() + problem.free_eo.sum()
            + problem.free_global.sum())
    return n_obs - u


def rms_sigmas(Q, free, sigma0):
    """RMS of sigma0 sqrt(diag) over the free points' blocks [k, 3, 3]."""
    var = torch.diagonal(Q[free], dim1=1, dim2=2) * sigma0 ** 2
    return torch.sqrt(var.mean(dim=0)).tolist()


def point_major(dev, P, M, V):
    """solve (f32) -> refine.converge -> cov_all (f64)."""
    t0 = time.perf_counter()
    prob_h, state_h, spec = synthetic.build_problem(P, M, V, seed=0)
    p32 = convert.problem_to_torch(prob_h, dev, torch.float32)
    s32 = convert.state_to_torch(state_h, dev, torch.float32)
    print(f"point-major network: P={p32.num_points} M={M} V={V}, "
          f"{time.perf_counter() - t0:.1f} s to build")

    t = time.perf_counter()
    res = solver.solve(p32, s32, spec, damping=1e-2, max_iterations=30,
                       tolerance=F32_STOP)
    f32_s = time.perf_counter() - t
    print(f"f32 solve: {res.status.name} after {res.iterations} steps in "
          f"{f32_s:.2f} s, max|dx| {res.max_abs_dx:.2e}, preconditioner per "
          f"step {[h['precond'] for h in res.history]}")

    refiner = refine.Refiner(p32, spec, use_kernels=dev.type == "cuda")
    phase = lm.LMPhase(steps=res.iterations, max_dx=res.max_abs_dx,
                       cg_iterations=[h["cg_it"] for h in res.history],
                       seconds=f32_s)
    s_ref, rec = refine.converge(refiner, (res.state, phase),
                                 tolerance=REFINE_TOL, damping=0.0)
    st64 = hilo.to_f64(s_ref)
    print(f"refinement: {rec.refine_steps} steps in {rec.refine_seconds:.2f}"
          f" s, max|dx| " + ", ".join(f"{x:.2e}" for x in rec.max_dx))

    fm64 = engine.fm_problem(convert.problem_to_torch(prob_h, dev,
                                                      torch.float64))
    omega = float(engine.linearize(fm64, st64, spec, 0.0).omega0)
    sigma0 = math.sqrt(omega / dof_of(p32))
    t = time.perf_counter()
    Q = cov_direct.cov_all(fm64, st64, spec)
    free = p32.free_point[:, 0] > 0
    rms = rms_sigmas(Q, free, sigma0)
    print(f"sigma0 {sigma0:.6e}; cov_all (f64) {time.perf_counter() - t:.2f}"
          f" s: RMS sigma X/Y/Z of {int(free.sum())} points "
          + ", ".join(f"{x:.3e}" for x in rms))
    return dict(sigma0=sigma0, f32_steps=res.iterations,
                refine_steps=rec.refine_steps, max_dx=rec.max_dx[-1],
                converged=rec.converged, rms_sigma=rms)


def file_order(dev, P, M, V):
    """The same story on a network of uneven visibility in file order."""
    t0 = time.perf_counter()
    ph, sh, spec = synthetic.build_problem(P, M, 2 * V, seed=0)
    fh, fsh = synthetic.thin_views(ph, sh, views=V, every=THIN_EVERY)
    p32 = convert.problem_to_torch(fh, dev, torch.float32)
    s32 = convert.state_to_torch(fsh, dev, torch.float32)
    print(f"file-order network: P={p32.num_points} M={M}, "
          f"N={fh.obs_point.shape[0]} rows ({V} or {2 * V} views), "
          f"{time.perf_counter() - t0:.1f} s to build")

    t = time.perf_counter()
    r32 = solver.solve(p32, s32, spec, damping=1e-2, max_iterations=30,
                       tolerance=F32_STOP)
    print(f"f32 solve: {r32.status.name} after {r32.iterations} steps in "
          f"{time.perf_counter() - t:.2f} s, max|dx| {r32.max_abs_dx:.2e}")

    refiner = refine.Refiner(p32, spec)
    phase = lm.LMPhase(steps=r32.iterations, max_dx=r32.max_abs_dx,
                       cg_iterations=[h["cg_it"] for h in r32.history],
                       seconds=0.0)
    s_ref, rec = refine.converge(refiner, (r32.state, phase),
                                 tolerance=REFINE_TOL, damping=0.0)
    st64 = hilo.to_f64(s_ref)
    print(f"refinement on the file order: {rec.refine_steps} steps in "
          f"{rec.refine_seconds:.2f} s, max|dx| "
          + ", ".join(f"{x:.2e}" for x in rec.max_dx))

    p64 = convert.problem_to_torch(fh, dev, torch.float64)
    omega = float(rcs.linearize(p64, st64, spec, 0.0).omega0)
    sigma0 = math.sqrt(omega / dof_of(p64))
    # free points, one in all its views and one in half of them
    ids = np.array([THIN_EVERY, 3], np.int32)
    t = time.perf_counter()
    b, Minv = covariance.prepare(p64, st64, spec)
    Q = covariance.point_covariance_blocks(p64, b, Minv, ids)
    sig = (torch.sqrt(torch.diagonal(Q, dim1=1, dim2=2)) * sigma0).tolist()
    print(f"sigma0 {sigma0:.6e}; point blocks on demand "
          f"{time.perf_counter() - t:.2f} s: sigma X/Y/Z of points "
          f"{ids.tolist()}: " + "; ".join(
              ", ".join(f"{x:.3e}" for x in s) for s in sig))
    return dict(sigma0=sigma0, f32_steps=r32.iterations,
                refine_steps=rec.refine_steps, max_dx=rec.max_dx[-1],
                converged=rec.converged, point_sigmas=sig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    ap.add_argument("shape", nargs="*", type=int, default=[20_000, 100, 8],
                    metavar="N", help="num_points num_images views")
    args = ap.parse_args(argv)
    if len(args.shape) != 3:
        ap.error("give num_points num_images views, or none of them")
    if not args.cpu and not torch.cuda.is_available():
        ap.exit(2, "no GPU here (torch.cuda.is_available() is false): pass "
                   "--cpu to run on the CPU\n")
    dev = torch.device("cpu" if args.cpu else "cuda")
    t0 = time.perf_counter()
    out = dict(device=str(dev), shape=args.shape,
               point_major=point_major(dev, *args.shape),
               file=file_order(dev, *args.shape))
    out["seconds"] = time.perf_counter() - t0
    print(f"total {out['seconds']:.1f} s")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
