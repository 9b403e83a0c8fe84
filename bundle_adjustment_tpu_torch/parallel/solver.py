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

import enum
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..models.problem import ParamState
from . import engine, rcs

#: sqrt of the relative machine epsilon of binary64 as the dense solver
#: computes it (halving until 1 + eps == 1: 2^-53, half of numpy's eps)
SQRT_EPS = math.sqrt(2.0 ** -53)


class EstimationState(enum.IntEnum):
    """Status ids of an estimation (the dense solver's taxonomy)."""

    ERROR_FREE_ESTIMATION = 1
    BUSY = 0
    ITERATE = -1
    CONVERGENCE = -2
    LEVENBERG_MARQUARDT_STEP = -3
    INVERT_NORMAL_EQUATION_MATRIX = -4
    ESTIMATE_STOCHASTIC_PARAMETERS = -5
    INTERRUPT = -6
    SINGULAR_MATRIX = -7
    NO_CONVERGENCE = -8
    OUT_OF_MEMORY = -9
    EXPORT_ADJUSTMENT_RESULTS = -10
    EXPORT_ADJUSTMENT_RESULTS_FAILED = -11


def lm_gain_update(adapted_damping: float, omega_prev: float,
                   omega_cur: float):
    """The gain-ratio damping schedule.

    prevOmega >= curOmega accepts the step and relaxes lambda x0.2;
    otherwise lambda grows x5 up to the runaway cap 1 / sqrt(eps), at
    which point Omega is reset to 0 so that the *next* gain test
    necessarily accepts: the escape hatch that forces a step instead of
    diverging lambda.

    Returns (new_damping, new_omega, accepted)."""
    prev = omega_prev if omega_prev > 0 else float(torch.finfo(
        torch.float64).max)
    if prev >= omega_cur:
        return adapted_damping * 0.2, omega_cur, True
    adapted_damping *= 5.0
    omega = omega_cur
    if adapted_damping > 1.0 / SQRT_EPS:
        adapted_damping = 1.0 / SQRT_EPS
        omega = 0.0
    return adapted_damping, omega, False


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
    (`engine.lm_step_full`); the default is True for CUDA tensors and
    False for CPU tensors.  The point count is then padded to the kernels'
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
        use_kernels = state.points.is_cuda

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
            fmp, kernels.choose_pb(fmp.num_points, fmp.views))

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
