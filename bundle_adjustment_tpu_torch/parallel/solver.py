"""Large-scale LM loop: the reference's damping semantics over the
feature-major engine (PyTorch port of
`bundle_adjustment_tpu/parallel/solver.py`).

The Levenberg-Marquardt bookkeeping of the dense solver (multiplicative
damping, alpha-scaled steps, the 0.2x / 5x gain schedule on Omega, step
rejection, damping shut-off, convergence on max|dx|) drives
`engine.lm_step_full`: linearise, the fused assembly, PCG on the implicit
Schur complement with the free-network corrections of `freenet`, and
back-substitution.

The convergence criterion at scale: the dense solver's sqrt(eps_f64)
threshold is unreachable in f32, so the default tolerance is scaled to the
working dtype (the square root of its machine epsilon).  An f32 run ends
there; `refine.Refiner` takes the state further.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..models.problem import ParamState
from ..solver.adjustment import BundleAdjustment as _DenseBundleAdjustment
from ..solver.adjustment import (SQRT_EPS, EstimationState, EstimationType,
                                 _Kernels, lm_gain_update)
from . import engine, rcs

__all__ = ["SQRT_EPS", "EstimationState", "RCSResult", "ScaleBundleAdjustment",
           "lm_gain_update", "solve"]


@dataclass
class RCSResult:
    state: ParamState
    converged: bool
    iterations: int
    omega: float
    max_abs_dx: float
    history: list = field(default_factory=list)
    status: EstimationState = None

    def __post_init__(self):
        if self.status is None:
            self.status = (EstimationState.ERROR_FREE_ESTIMATION
                           if self.converged
                           else EstimationState.NO_CONVERGENCE)


def solve(problem: rcs.RCSProblem, state: ParamState, spec,
          damping: float = 0.0,
          max_iterations: int = 100,
          tolerance: Optional[float] = None,
          cg_tol: float = 1e-6,
          cg_maxiter: int = 100,
          use_kernels: Optional[bool] = None,
          verbose: bool = False,
          simulation: bool = False,
          listeners: Optional[list] = None,
          interrupted: Optional[Callable[[], bool]] = None) -> RCSResult:
    """Run the LM loop to convergence on a large-scale problem (tensors of
    `convert.problem_to_torch` / `state_to_torch`; the solve runs on their
    device).

    ``use_kernels``: run every step through K3 / K2 / K1
    (`engine.lm_step_full`); the default is True for f32 CUDA tensors
    (the kernels take f32 only) and False for every other state, so an
    f64 solve on the card runs the plain path there.  The point count is then padded to the kernels'
    block size with dummy points (`engine.pad_problem`), which the
    returned state drops again.
    ``simulation``: the right-hand side is zeroed, so every step is
    exactly 0 and Omega = 0; one linearisation still runs, so that
    singular geometry surfaces (pure variance propagation for network
    design).
    ``listeners``: callbacks ``fn(name, old, new)`` fired with the event
    names ITERATE per iteration with (max_iterations, k),
    LEVENBERG_MARQUARDT_STEP with (lambda_old, lambda_new), CONVERGENCE
    with (tolerance, max_dx), INTERRUPT, SINGULAR_MATRIX, NO_CONVERGENCE.
    ``interrupted``: zero-argument callable polled once per iteration;
    True stops the loop with status INTERRUPT.
    """
    dtype = state.points.dtype
    if tolerance is None:
        tolerance = math.sqrt(torch.finfo(dtype).eps)
    if use_kernels is None:
        use_kernels = (state.points.is_cuda
                       and state.points.dtype == torch.float32)

    def fire(name, old, new):
        for fn in (listeners or ()):
            fn(name, old, new)

    num_points = problem.num_points
    if use_kernels:
        from . import kernels

        problem, state, _ = engine.pad_problem(problem, state, 128)
    fmp = engine.fm_problem(problem)
    if use_kernels:
        fmp = engine.to_view_major(
            fmp, kernels.choose_pb(fmp.num_points, fmp.views,
                                   fmp.free_global.shape[0]))

    def unpadded(st):
        return st._replace(points=st.points[:num_points])

    def step(st, lam, maxiter):
        return engine.lm_step_full(fmp, problem, st, spec, lam,
                                   cg_tol=cg_tol, cg_maxiter=maxiter,
                                   use_kernels=use_kernels)

    if simulation:
        # zero rhs => dx = 0 exactly; one linearisation pass so that
        # singular geometry still surfaces, then the zero result.  Event
        # stream: one ITERATE (the single validation pass), then
        # CONVERGENCE.
        fire("ITERATE", max_iterations, 1)
        b = step(state, 0.0, 0)[3]
        ok = bool(torch.isfinite(b.omega0))
        fire("CONVERGENCE", tolerance, 0.0)
        return RCSResult(state=unpadded(state), converged=ok, iterations=0,
                         omega=0.0, max_abs_dx=0.0,
                         history=[{"iter": 0, "max_dx": 0.0, "damping": 0.0,
                                   "cg_it": 0, "omega0": 0.0}],
                         status=(EstimationState.ERROR_FREE_ESTIMATION
                                 if ok else EstimationState.SINGULAR_MATRIX))

    adapted = float(damping)
    omega_prev = 0.0
    last_valid_dx = 0.0
    history = []
    converged = False
    it_done = 0
    max_dx = float("inf")
    for k in range(max_iterations):
        it_done = k + 1
        fire("ITERATE", max_iterations, it_done)
        dxp, dxc, dxg, b, cg_it, ext = step(state, adapted, cg_maxiter)

        rejected = False
        alpha = 1.0
        if adapted > 0:
            alpha = min(0.25 * adapted ** -0.05, 0.75)
            cur = float(engine.omega_at_full(
                fmp, problem, b, ext, alpha * dxp, alpha * dxc, alpha * dxg,
                state))
            lam_old = adapted
            adapted, omega_prev, accepted = lm_gain_update(
                adapted, omega_prev, cur)
            if not accepted:
                rejected = True
                max_dx = last_valid_dx
            fire("LEVENBERG_MARQUARDT_STEP", lam_old, adapted)

        omega0 = float(b.omega0)
        if not rejected:
            state, mdx = rcs.apply_step(state, alpha * dxp, alpha * dxc,
                                        alpha * dxg)
            max_dx = float(mdx)
            last_valid_dx = max_dx
            if omega_prev == 0.0:
                omega_prev = omega0

        history.append({"iter": it_done, "max_dx": max_dx,
                        "damping": adapted, "cg_it": int(cg_it),
                        "omega0": omega0, "accepted": not rejected})
        if verbose:
            print(f"it={it_done} max|dx|={max_dx:.3e} lam={adapted:.2e} "
                  f"cg={int(cg_it)} omega0={omega0:.4e}")

        if interrupted is not None and interrupted():
            fire("INTERRUPT", False, True)
            return RCSResult(state=unpadded(state), converged=False,
                             iterations=it_done, omega=omega_prev,
                             max_abs_dx=max_dx, history=history,
                             status=EstimationState.INTERRUPT)

        if not math.isfinite(max_dx):
            fire("SINGULAR_MATRIX", False, True)
            return RCSResult(state=unpadded(state), converged=False,
                             iterations=it_done, omega=omega_prev,
                             max_abs_dx=max_dx, history=history,
                             status=EstimationState.SINGULAR_MATRIX)
        if max_dx <= tolerance and adapted == 0:
            converged = True
            fire("CONVERGENCE", tolerance, max_dx)
            break
        fire("CONVERGENCE", tolerance, max_dx)
        if adapted <= tolerance or k > max_iterations * 0.5:
            adapted = 0.0

    if not converged:
        fire("NO_CONVERGENCE", tolerance, max_dx)
    return RCSResult(state=unpadded(state), converged=converged,
                     iterations=it_done, omega=omega_prev, max_abs_dx=max_dx,
                     history=history)


class ScaleBundleAdjustment(_DenseBundleAdjustment):
    """The reference `BundleAdjustment` user API (setters, listeners,
    interrupt, SIMULATION, result writers, checkpoints) solved by the
    feature-major engine instead of the dense bordered factorisation.

    Subclasses the dense solver and swaps its `_Kernels`:

    * intermediate iterations run `engine.lm_step_full` on the problem's
      `rcs.rcs_from_problem` (point-eliminated implicit-Schur PCG, the
      scale bars, inner constraints and direct groups of `freenet`) in
      float64 on the solver's device, through the plain path (the CUDA
      kernels take f32 only), and scatter the step back into the dense
      column layout, so the parent's LM bookkeeping, event stream,
      interrupt, centroiding and checkpointing run unchanged;
    * the FINAL stochastic pass (covariance by the requested
      MatrixInversion mode) keeps the parent's dense kernel: Qxx is dense
      by contract there.  At array scale use `solve()` +
      `parallel.cov_direct` for block covariance recovery instead.

    One camera only: the feature-major engine has no multi-camera layout
    yet (ROADMAP.md, Queue 1 item 2, "The compact multi-camera layout").
    `BundleAdjustment` takes any number of cameras.
    """

    cg_tol: float = 1e-12
    cg_maxiter: int = 2000

    def _build_kernels(self):
        bp = self.problem
        if bp.num_cameras != 1:
            raise NotImplementedError(
                f"ScaleBundleAdjustment takes one camera, not "
                f"{bp.num_cameras}: the feature-major engine has no "
                "multi-camera layout yet (ROADMAP.md, Queue 1 item 2, \"The "
                "compact multi-camera layout\"); use BundleAdjustment")
        base = super()._build_kernels()
        dev, dt = self.device, self.dtype
        rp = rcs.rcs_from_problem(bp, dev, dt)
        fmp = engine.fm_problem(rp)
        spec = bp.spec
        simulation = self.estimation_type == EstimationType.SIMULATION
        T = bp.total_size

        def dump(cols):
            cols = np.asarray(cols).ravel()
            return torch.as_tensor(np.where(cols >= 0, cols, T).astype(np.int64),
                                   device=dev)

        cols_p = dump(bp.col_points)
        cols_e = dump(bp.col_eo)
        cols_g = dump(np.concatenate([np.concatenate([bp.col_io[c],
                                                      bp.col_dist[c]])
                                      for c in range(bp.num_cameras)]))

        def solve_intermediate(state, damping):
            if simulation:
                return torch.zeros(T, dtype=dt, device=dev)
            dxp, dxc, dxg, _, _, _ = engine.lm_step_full(
                fmp, rp, state, spec, damping, cg_tol=self.cg_tol,
                cg_maxiter=self.cg_maxiter)
            dx = torch.zeros(T + 1, dtype=dt, device=dev)
            dx[cols_p] = dxp.reshape(-1)
            dx[cols_e] = dxc.reshape(-1)
            dx[cols_g] = dxg
            return dx[:T]

        def solve_final(state, damping):
            # dx by the scale engine, Qxx by the dense stochastic pass
            dx = solve_intermediate(state, damping)
            _, Q = base.solve_final(state, damping)
            return dx, Q

        return _Kernels(assemble=base.assemble, omega=base.omega,
                        solve_intermediate=solve_intermediate,
                        solve_final=solve_final)
