"""Mixed-precision refinement: f64 gradient + hi/lo state + f32 solve.

Port of `bundle_adjustment_tpu/parallel/refine.py` and of the
time-to-converged loop of `bench.py` (`converge`).

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

import math
import time
from typing import NamedTuple

import torch

from .. import convert
from ..models.problem import ParamState
from ..solver import tracing
from . import engine, freenet, hilo, kernels, rcs


def upcast_problem(problem: rcs.RCSProblem) -> rcs.RCSProblem:
    """f32 -> f64 copy of the float tensors (indices untouched)."""
    def up(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.double()
        return x

    return rcs.RCSProblem(*(up(x) for x in problem))


class Refiner:
    """Mixed-precision refiner of a tensor RCSProblem in either layout
    (`rcs.LAYOUTS`); the layout picks the engine, once, here:

    * uniform point-major (``point_uniform`` set): the feature-major
      engine (`engine.py`) with the CUDA kernels K1, K2 and K3;
    * file order (``point_uniform`` None, any number of views per point,
      the point order of `convert.problem_to_torch`): the block-layout
      engine (`rcs.linearize` .. `rcs.back_substitute_points`), in that
      layout, never padded, with K3 for the EO gathers.  Its CG takes
      block Jacobi whatever ``couple_global`` says, as `solver.solve`'s
      file route does, and its Jacobian is taken at the hi part of the
      state (the right-hand side is the f64 gradient).

    Takes the extras of the scale path on the point-major layout: scale
    bars, the Helmert inner-constraint datum and populated direct groups
    (the low-rank corrections of `freenet`, their coefficients in f32, the
    cancelling bar and group misclosures from the f64 pass); on the file
    order they raise ValueError.  Diagonal direct observations are folded
    by the f64 lineariser on both (on the point-major layout the EO term
    of the camera rhs is added in `gradient64`).

    Usage:
        r = Refiner(problem32, spec, use_kernels=True)
        s = hilo.from_f32(state32)          # after the f32 LM phase
        s, max_dx, omega0, it = r.step(s)   # repeat until max_dx <= tol

    ``problem32``: the port's tensor RCSProblem in f32 (`convert`), on the
    device that runs the solve.  The f64 problem is its upcast (the same
    f32-rounded observations), on the same device, in the same layout;
    on the point-major layout the f32 one is view-major when
    ``use_kernels``.  Both reduce per point and per image, so the
    gradient blocks do not depend on the lane order.  ``fmp32`` /
    ``fmp64`` are the problems the engine reads: FMProblems on the
    point-major layout, the RCSProblems themselves on the file order.

    ``use_kernels``: on the point-major layout each step runs K3 in
    linearise and back-substitution, K2 for the assembly and K1 on every
    CG iteration (`kernels.prepare_kernels` + `kernels.make_matvec`); on
    the file order K3 alone; for CPU tensors the wrappers take their
    plain versions.  K1 and K2 take one camera: a point-major
    multi-camera problem (the compact rows) refines on the plain path,
    and ``use_kernels=True`` raises ValueError for it.  None (the
    default) takes `solver.solve`'s rule (`kernels.runs_kernels`): the
    route's kernels for an f32 problem on a card (point-major: one camera
    only), else the plain path; kernel names as `solve` takes them.

    The point-major plain product, in f32 or in f64, is marked
    ``capturable`` as `engine.lm_step` marks its own: on a card `rcs.pcg`
    replays its CG iteration as a CUDA graph.  The extras' wrapped product
    and preconditioner (`freenet`) and the block layout's product keep the
    eager route.

    ``couple_global`` (the JAX Refiner's option): precondition the f32 CG
    with the exact camera-global blocks (default), or with the camera and
    global blocks alone (block Jacobi); the file order takes block Jacobi.

    The inner solve in f64 (``inner64``): the step's `engine.prepare`
    (`rcs.prepare`), preconditioner, plain product and CG on the f64
    problem the gradient pass holds, in a span ``refine.step64``.  A
    camera rig takes it from the first step of each refinement (`begin`):
    its f32 operator does not hold the rig's weakest mode, each camera's
    calibration against its images' EO, and on the 4-camera 100k rig the
    f32 steps moved the state by 1e-3 .. 1e-1 where the correction was
    0.3 .. 1.1, for one to five steps, until a CG returned its zero start
    (PERF.md).  On one
    camera a step whose f32 CG returns its zero start on a nonzero
    right-hand side (no iterate lowered |r|_2) solved nothing: it is
    redone in f64, and the rest of the refinement solves in f64.  A step
    whose f64 CG fails too moves the points only and reads max|dx| inf,
    never 0, so `refine` and `converge` stop and report no
    convergence."""

    @tracing.traced("refine.build")
    def __init__(self, problem32: rcs.RCSProblem, spec,
                 use_kernels: bool | None = None, couple_global: bool = True):
        convert.refuse_unsupported(problem32)
        self.file_order = problem32.point_uniform is None
        if self.file_order and problem32.has_extras:
            raise ValueError(
                "the refinement of a problem in the 'file' layout takes no "
                "scale bars, inner-constraint datum or populated direct "
                "groups (the point-major layout does: rcs.to_point_major)")
        x = problem32.obs_xy
        use_kernels = kernels.runs_kernels(problem32, use_kernels, x.dtype,
                                           x.device)
        self.problem32 = problem32
        self.spec = spec
        self.use_kernels = use_kernels
        self.couple_global = couple_global
        self.begin()
        tracing.count("rows", int(problem32.obs_point.shape[0]))
        # the f64 problem also holds the bar and group geometry of the f64
        # misclosures (tiny)
        self.problem64 = upcast_problem(problem32)
        if self.file_order:
            # the block-layout engine reads the problems as they are
            self.fmp32, self.fmp64 = problem32, self.problem64
        else:
            self.fmp32 = engine.fm_problem(problem32)
            if use_kernels:
                self.fmp32 = kernels.kernel_layout(self.fmp32)
            self.fmp64 = engine.fm_problem(self.problem64)

    def begin(self):
        """Start a refinement (`refine`, `converge`): its inner solve in
        f32, on a camera rig in f64 (``inner64``, `Refiner`)."""
        self.inner64 = engine.num_cameras(self.problem32) > 1

    @tracing.traced("refine.gradient64")
    def gradient64(self, fmp64, state64: ParamState):
        """(bp [P, 3], bc [M, 6], bg [G], omega0, wsb [R], wdpg [n]) in
        f64, the only f64 pass: the full-space gradient blocks J^T P w at
        ``state64`` incl. the diagonal direct observations (`linearize`
        folds dp / dg; the de camera term is added here), Omega incl. the
        bar and group rows, and the misclosures of the scale bars and of
        the populated direct group (empty without them)."""
        p64 = self.problem64
        if self.file_order:
            # the block layout's sums; bc holds the de term
            b = rcs.linearize(fmp64, state64, self.spec, 0.0)
            bp, bc = b.bp, b.bc
        else:
            b = engine.linearize(fmp64, state64, self.spec, 0.0)
            bp = torch.stack(b.bp, dim=1)
            bc = engine._image_sum_stack(
                fmp64,
                [b.Jc[a] * b.Pw[0] + b.Jc[6 + a] * b.Pw[1] for a in range(6)])
            if fmp64.de_w is not None:
                bc = bc + fmp64.de_w * fmp64.free_eo * (fmp64.de_val
                                                        - state64.eo)
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
        out = bp, bc, b.bg, omega0, wsb, wdpg
        del b  # the f64 rows (~80 per observation) go before the f32 step
        return out

    def _step_impl(self, s: hilo.HiLoState, damping, bp, bc, bg, wsb, wdpg,
                   f64=False, cg_tol=1e-7, cg_maxiter=400, stall_limit=200):
        """One step from ``s`` on the gradient blocks handed in, its inner
        solve in f32 on the f32 problem (``bp`` .. ``wdpg`` in f32) or, with
        ``f64``, in f64 on the f64 problem.  Returns (HiLoState, max|dx|,
        CG iterations, whether the CG failed)."""
        if f64:
            p, problem, kern = self.fmp64, self.problem64, False
            state, state_lo = hilo.to_f64(s), None
        else:
            p, problem, kern = self.fmp32, self.problem32, self.use_kernels
            state, state_lo = s.hi, s.lo
        cam_gather = kernels.make_cam_gather(p) if kern else None
        if self.file_order:
            b, _rc, _rg, Minv = rcs.prepare(p, state, self.spec, damping,
                                            cam_gather=cam_gather)
            ops = rcs.point_ops(p, b, cam_gather=cam_gather)
        else:
            if kern:
                b, _rc, _rg, Minv, pp = kernels.prepare_kernels(
                    p, state, self.spec, damping,
                    couple_global=self.couple_global, state_lo=state_lo,
                    cam_gather=cam_gather)
            else:
                b, _rc, _rg, Minv = engine.prepare(
                    p, state, self.spec, damping,
                    couple_global=self.couple_global, state_lo=state_lo)
            ops = engine.point_ops(p, b, cam_gather=cam_gather)
        z0 = ops.hinv(bp)
        dc, dg = ops.hxp(z0)
        rc = bc - dc
        rg = bg - dg
        if self.file_order:
            b = b._replace(bp=bp, bc=bc, bg=bg)

            def matvec(c, g):
                return rcs.schur_matvec(p, b, c, g)
        else:
            b = b._replace(bp=tuple(bp[:, a] for a in range(3)), bc=bc,
                           bg=bg)
            if kern:
                # the rows packed once by prepare_kernels above
                matvec = kernels.make_matvec(pp, b.extra_c, b.extra_g)
            else:
                def matvec(c, g):
                    return engine.schur_matvec(p, b, c, g)

                matvec.capturable = True
        ext = None
        if problem.has_extras:
            # the exact low-rank corrections around the f64 gradient: the
            # coefficients (U, B, Cap, Bb) from the current state, the
            # cancelling misclosures from the f64 pass
            ext = freenet.prepare_extras(
                problem, state, bp, rc, rg, ops, 0.0,
                sb_misclosure=wsb, dpg_misclosure=wdpg)
            rc, rg = ext.rc, ext.rg
            matvec = freenet.wrap_matvec(matvec, ext)
            Minv = freenet.wrap_precond(rcs.make_apply_M(Minv), ext)
        xc, xg, it = rcs.pcg(rc, rg, Minv, matvec, tol=cg_tol,
                             maxiter=cg_maxiter, stall_limit=stall_limit)
        del matvec  # K1's workspace goes before the back-substitution
        failed = not (bool(xc.any()) or bool(xg.any())) \
            and (bool(rc.any()) or bool(rg.any()))
        if ext is not None:
            dxp, _lam = freenet.back_substitute(problem, ext, ops, xc, xg)
        elif self.file_order:
            dxp = rcs.back_substitute_points(p, b, xc, xg,
                                             cam_gather=cam_gather)
        else:
            dxp = engine.back_substitute_points(p, b, xc, xg,
                                                cam_gather=cam_gather)
        if f64:
            # the f64 step on the f64 state, split back into hi + lo
            new64, max_dx = rcs.apply_step(state, dxp, xc, xg)
            new_s = hilo.from_f64(new64)
        else:
            new_s, max_dx = hilo.apply_step(s, dxp, xc, xg)
        if failed:
            max_dx = torch.full_like(max_dx, float("inf"))
        return new_s, max_dx, it, failed

    @tracing.traced("refine.step")
    def step(self, s: hilo.HiLoState, damping=1e-8,
             cg_tol=1e-7, cg_maxiter=400, stall_limit=200):
        """One refinement step from ``s``: returns (HiLoState, max|dx| 0-d
        tensor, inf where the CG failed, f64 Omega at ``s``, CG
        iterations).  The inner solve runs in f64 once ``inner64`` is set,
        and a failed f32 CG redoes the step so (`Refiner`); the iterations
        are then the two solves' together."""
        bp64, bc64, bg64, omega0, wsb, wdpg = self.gradient64(
            self.fmp64, hilo.to_f64(s))
        kw = dict(cg_tol=cg_tol, cg_maxiter=cg_maxiter,
                  stall_limit=stall_limit)
        it32 = 0
        if not self.inner64:
            f32 = torch.float32
            new_s, max_dx, it32, failed = self._step_impl(
                s, damping, bp64.to(f32), bc64.to(f32), bg64.to(f32),
                wsb.to(f32), wdpg.to(f32), **kw)
            if not failed:
                return new_s, max_dx, omega0, it32
            self.inner64 = True
        with tracing.span("refine.step64"):
            new_s, max_dx, it, _ = self._step_impl(
                s, damping, bp64, bc64, bg64, wsb, wdpg, f64=True, **kw)
            tracing.count("iterations", it)
        return new_s, max_dx, omega0, it32 + it

    def refine(self, state32: ParamState, tolerance: float = 1e-6,
               max_iterations: int = 12, **kw):
        """Drive refinement until max|dx| <= tolerance, or a step's CG
        fails (max|dx| inf, `Refiner`).
        Returns (HiLoState, history list of max|dx|)."""
        s = hilo.from_f32(state32)
        self.begin()
        history = []
        for _ in range(max_iterations):
            s, max_dx, omega0, it = self.step(s, **kw)
            history.append(float(max_dx))
            if history[-1] <= tolerance or math.isinf(history[-1]):
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
    converged: bool       # the last max|dx| <= tolerance (a failed CG: no)
    f64_steps: int = 0    # steps whose inner solve ran in f64 (`Refiner`)

    @property
    def time_to_converged_s(self) -> float:
        return self.f32_seconds + self.refine_seconds


def converge(refiner: Refiner, lm_result, tolerance=1e-6, max_steps=15,
             damping=1e-7, cg_tol=1e-12, cg_maxiter=800, stall_limit=300):
    """The time-to-converged loop of `bench.py` after its f32 LM phase:
    from ``lm_result`` = `lm.run`'s (state, LMPhase), refine a hi/lo state
    until max|dx| <= ``tolerance``, ``max_steps`` steps or a step whose CG
    failed in f64 too (`Refiner`; the record's ``converged`` is then
    False).  The record counts the steps whose inner solve ran in f64.

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
    refiner.begin()
    history, its = [], []
    f64_steps = 0
    t0 = time.perf_counter()
    for _ in range(max_steps):
        s, max_dx, _omega0, it = refiner.step(
            s, damping=damping, cg_tol=cg_tol, cg_maxiter=cg_maxiter,
            stall_limit=stall_limit)
        history.append(float(max_dx))  # a host read: the step has ended
        its.append(it)
        f64_steps += refiner.inner64
        if history[-1] <= tolerance or math.isinf(history[-1]):
            break
    seconds = time.perf_counter() - t0
    return s, Convergence(f32_steps=phase.steps, f32_seconds=phase.seconds,
                          refine_steps=len(history), refine_seconds=seconds,
                          max_dx=history, cg_iterations=its,
                          converged=history[-1] <= tolerance,
                          f64_steps=f64_steps)
