"""Mixed-precision refinement: f64 gradient + hi/lo state + f32 solve.

Port of `bundle_adjustment_tpu/parallel/refine.py` (single camera) and of
the time-to-converged loop of `bench.py` (`converge`).

The f32 LM phase floors at max|dx| ~ 1e-3 because the gradient
g = J^T P w is a massively cancelling reduction: near the optimum it is
orders of magnitude below its terms, and f32 rounding noise (amplified by
S^{-1}) dominates the step.  Classic iterative refinement fixes it:
evaluate only the gradient in f64, keep the state as an f32 hi + lo pair
(`hilo`), and run the assembly, the preconditioner and CG in f32.  Each
outer step then contracts the state error by the relative accuracy of the
f32 solve.

The f64 pass is the full f64 linearise and the full f64 reduction.  An
f64 residual with f32 Jacobian rows or an f32 J^T P w sum floors the
gradient at eps32 * sqrt(N) * |J P w|_rms: the cancellation is across
observation terms whose residuals converge to the noise, not to zero (the
reference measured a stall at max|dx| ~ 2e-5).  On a GPU the pass runs on
the device in native f64 through the plain gathers (the CUDA kernels take
f32 only); the reference's detour through the host CPU worked around the
TPU's emulated f64 and is not needed.

The CG stall rule must be relaxed here: the f32 default (8) exits at ~20%
relative residual, which is the contraction rate itself.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from .. import convert
from ..models.problem import ParamState
from . import engine, freenet, hilo, rcs


def upcast_problem(problem: rcs.RCSProblem) -> rcs.RCSProblem:
    """f32 -> f64 copy of the float tensors (indices untouched)."""
    def up(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.double()
        return x

    return rcs.RCSProblem(*(up(x) for x in problem))


class Refiner:
    """Engine-path (feature-major) mixed-precision refiner.

    Takes the extras of the scale path: scale bars, the Helmert
    inner-constraint datum and populated direct groups (the low-rank
    corrections of `freenet`, their coefficients in f32, the cancelling
    bar and group misclosures from the f64 pass) and diagonal direct
    observations (folded by the f64 lineariser; the EO term of the camera
    rhs is added in `gradient64`).

    Usage:
        r = Refiner(problem32, spec, use_kernels=True)
        s = hilo.from_f32(state32)          # after the f32 LM phase
        s, max_dx, omega0, it = r.step(s)   # repeat until max_dx <= tol

    ``problem32``: the port's tensor RCSProblem in f32 (`convert`), on the
    device that runs the solve.  The f64 problem is its upcast (the same
    f32-rounded observations), on the same device, in the point-major
    layout; the f32 one is view-major when ``use_kernels``.  Both reduce
    per point and per image, so the gradient blocks do not depend on the
    lane order.

    ``use_kernels``: each step runs K3 in linearise and back-substitution,
    K2 for the assembly and K1 on every CG iteration
    (`kernels.prepare_kernels` + `kernels.make_matvec`); for CPU tensors
    the wrappers take their plain versions."""

    def __init__(self, problem32: rcs.RCSProblem, spec,
                 use_kernels: bool = False):
        convert.refuse_unsupported(problem32)
        self.problem32 = problem32
        self.spec = spec
        self.use_kernels = use_kernels
        self.fmp32 = engine.fm_problem(problem32)
        if use_kernels:
            from . import kernels

            f = self.fmp32
            self.fmp32 = engine.to_view_major(
                f, kernels.choose_pb(f.num_points, f.views,
                                     f.free_global.shape[0]))
        # the f64 problem also holds the bar and group geometry of the f64
        # misclosures (tiny)
        self.problem64 = upcast_problem(problem32)
        self.fmp64 = engine.fm_problem(self.problem64)

    def gradient64(self, fmp64, state64: ParamState):
        """(bp [P, 3], bc [M, 6], bg [G], omega0, wsb [R], wdpg [n]) in
        f64, the only f64 pass: the full-space gradient blocks J^T P w at
        ``state64`` incl. the diagonal direct observations (`linearize`
        folds dp / dg; the de camera term is added here), Omega incl. the
        bar and group rows, and the misclosures of the scale bars and of
        the populated direct group (empty without them)."""
        p64 = self.problem64
        b = engine.linearize(fmp64, state64, self.spec, 0.0)
        bc = engine._image_sum_stack(
            fmp64,
            [b.Jc[a] * b.Pw[0] + b.Jc[6 + a] * b.Pw[1] for a in range(6)])
        if fmp64.de_w is not None:
            bc = bc + fmp64.de_w * fmp64.free_eo * (fmp64.de_val - state64.eo)
        omega0 = b.omega0
        wsb = wdpg = state64.points.new_zeros((0,))
        if freenet.has_rows(p64.sb_a):
            dvec = state64.points[p64.sb_b.long()] \
                - state64.points[p64.sb_a.long()]
            wsb = p64.sb_length - torch.sqrt(torch.sum(dvec * dvec, dim=1))
            omega0 = omega0 + torch.sum(p64.sb_weight * wsb * wsb)
        if freenet.has_rows(p64.dpg_idx):
            cur = torch.gather(state64.points[p64.dpg_idx.long()], 1,
                               p64.dpg_axis.long()[:, None])[:, 0]
            wdpg = p64.dpg_val - cur
            omega0 = omega0 + torch.dot(
                wdpg, freenet.solve_vec(p64.dpg_cov, wdpg))
        out = torch.stack(b.bp, dim=1), bc, b.bg, omega0, wsb, wdpg
        del b  # the f64 rows (~80 per observation) go before the f32 step
        return out

    def _step_impl(self, s: hilo.HiLoState, damping, bp32, bc32, bg32,
                   wsb32, wdpg32, cg_tol=1e-7, cg_maxiter=400,
                   stall_limit=200):
        p32 = self.fmp32
        cam_gather = None
        if self.use_kernels:
            from . import kernels

            cam_gather = kernels.make_cam_gather(p32)
            b, _rc, _rg, Minv, pp = kernels.prepare_kernels(
                p32, s.hi, self.spec, damping, state_lo=s.lo,
                cam_gather=cam_gather)
        else:
            b, _rc, _rg, Minv = engine.prepare(p32, s.hi, self.spec, damping,
                                               couple_global=True,
                                               state_lo=s.lo)
        ops = engine.point_ops(p32, b, cam_gather=cam_gather)
        z0 = ops.hinv(bp32)
        dc, dg = ops.hxp(z0)
        rc = bc32 - dc
        rg = bg32 - dg
        b = b._replace(bp=tuple(bp32[:, a] for a in range(3)),
                       bc=bc32, bg=bg32)
        if self.use_kernels:
            # the rows packed once by prepare_kernels above
            matvec = kernels.make_matvec(pp, b.extra_c, b.extra_g)
        else:
            def matvec(c, g):
                return engine.schur_matvec(p32, b, c, g)
        ext = None
        if self.problem32.has_extras:
            # the exact low-rank corrections around the f64 gradient: the
            # coefficients (U, B, Cap, Bb) in f32 from the current hi
            # state, the cancelling misclosures from the f64 pass
            ext = freenet.prepare_extras(
                self.problem32, s.hi, bp32, rc, rg, ops, 0.0,
                sb_misclosure=wsb32, dpg_misclosure=wdpg32)
            rc, rg = ext.rc, ext.rg
            matvec = freenet.wrap_matvec(matvec, ext)
            Minv = freenet.wrap_precond(rcs.make_apply_M(Minv), ext)
        xc, xg, it = rcs.pcg(rc, rg, Minv, matvec, tol=cg_tol,
                             maxiter=cg_maxiter, stall_limit=stall_limit)
        if ext is not None:
            dxp, _lam = freenet.back_substitute(self.problem32, ext, ops,
                                                xc, xg)
        else:
            dxp = engine.back_substitute_points(p32, b, xc, xg,
                                                cam_gather=cam_gather)
        new_s, max_dx = hilo.apply_step(s, dxp, xc, xg)
        return new_s, max_dx, it

    def step(self, s: hilo.HiLoState, damping=1e-8,
             cg_tol=1e-7, cg_maxiter=400, stall_limit=200):
        """One refinement step from ``s``: returns (HiLoState, max|dx| 0-d
        tensor, f64 Omega at ``s``, CG iterations)."""
        bp64, bc64, bg64, omega0, wsb, wdpg = self.gradient64(
            self.fmp64, hilo.to_f64(s))
        f32 = torch.float32
        new_s, max_dx, it = self._step_impl(
            s, damping, bp64.to(f32), bc64.to(f32), bg64.to(f32),
            wsb.to(f32), wdpg.to(f32), cg_tol=cg_tol, cg_maxiter=cg_maxiter, stall_limit=stall_limit)
        return new_s, max_dx, omega0, it

    def refine(self, state32: ParamState, tolerance: float = 1e-6,
               max_iterations: int = 12, **kw):
        """Drive refinement until max|dx| <= tolerance.  Returns
        (HiLoState, history list of max|dx|)."""
        s = hilo.from_f32(state32)
        history = []
        for _ in range(max_iterations):
            s, max_dx, omega0, it = self.step(s, **kw)
            history.append(float(max_dx))
            if history[-1] <= tolerance:
                break
        return s, history


class Convergence(NamedTuple):
    """Record of one time-to-converged run (f32 LM phase + refinement)."""

    f32_steps: int
    f32_seconds: float
    refine_steps: int
    refine_seconds: float
    max_dx: list          # max|dx| after each refinement step
    cg_iterations: list   # CG iterations of each refinement step

    @property
    def time_to_converged_s(self) -> float:
        return self.f32_seconds + self.refine_seconds


def converge(refiner: Refiner, lm_result, tolerance=1e-6, max_steps=15,
             damping=1e-7, cg_tol=1e-12, cg_maxiter=800, stall_limit=300):
    """The time-to-converged loop of `bench.py` after its f32 LM phase:
    from ``lm_result`` = `lm.run`'s (state, LMPhase), refine a hi/lo state
    until max|dx| <= ``tolerance`` or ``max_steps`` steps.

    The defaults are the bench's settings.  ``cg_tol`` is unreachably
    tight on purpose: the refinement system is ill-conditioned, a
    residual-relative stop can exit with an O(1) step error, and the stall
    rule (a plateau of the best residual over ``stall_limit`` iterations)
    or the iteration cap is the real stop.

    The damping sets the outer contraction: each step solves
    (H + mu D) dx = -g, so a mode of H with eigenvalue lambda (relative
    to D) contracts by mu / (lambda + mu) per step.  At 100k points /
    500 images / 12 views the weakest mode has lambda ~ 5e-8, and the
    bench's mu = 1e-7 contracts it by ~2/3 per step: ~30 steps from the
    f32 LM phase's end, with the inner solve in f32 or in f64 alike
    (measured on an H100, PERF.md).  The reference reached 1e-6 on its TPU because
    its bf16-rounded preconditioner apply stalled CG before it moved
    that mode (rcs.py:538-548 of the JAX package).  ``damping=0.0``
    (undamped Gauss-Newton on the f64 gradient) converges in a few steps
    there.  Returns (HiLoState, Convergence)."""
    state32, phase = lm_result
    s = hilo.from_f32(state32)
    history, its = [], []
    t0 = time.perf_counter()
    for _ in range(max_steps):
        s, max_dx, _omega0, it = refiner.step(
            s, damping=damping, cg_tol=cg_tol, cg_maxiter=cg_maxiter,
            stall_limit=stall_limit)
        history.append(float(max_dx))  # a host read: the step has ended
        its.append(it)
        if history[-1] <= tolerance:
            break
    seconds = time.perf_counter() - t0
    return s, Convergence(f32_steps=phase.steps, f32_seconds=phase.seconds,
                          refine_steps=len(history), refine_seconds=seconds,
                          max_dx=history, cg_iterations=its)
