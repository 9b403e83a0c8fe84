"""The mixed-precision refinement on a self-calibrating camera rig, on the
CPU: the port's route to the optimum of a rig is `solver.solve` (f32) ->
`refine.Refiner(use_kernels=None, couple_global=False)` ->
`refine.converge(damping=0)`, as the benchmark's ``adjust_rig`` job runs
it.

The witness is `synthetic.build_problem(1000, 20, 12, seed=0,
num_cameras=4)` (G = 40, u = 160): the f32 inner solve does not hold the
rig's weakest mode (each camera's calibration against its images' EO;
its CG returns its zero start within a few steps, and the steps before
move the state the wrong way), so the Refiner runs a rig's inner solve
in f64 from the first step (`Refiner`).  Its answer is held to the
benchmark's plain reference (`benchmark/reference/rig.py`: autograd
Jacobians, the dense reduced system, LU, undamped Gauss-Newton from the
truth, on the observations rounded to f32 as the port gets them) within
`STATE_TOL` over every parameter.  The port lands ~1e-10 from it.  The
same reference in float32 misses it by ~1e-3: f32 Gauss-Newton floors
where the gradient J^T w, a sum that cancels to far below its terms near
the optimum, drowns in rounding (the floor the mixed-precision refinement
exists to remove), so it fails the tolerance.  The same network with one
camera converges with no f64 step, and, where its f32 CG is made to
fail (a stand-in `rcs.pcg` returns the zero start for f32), through the
f64 redo of that step and f64 steps after it.  CG budget: the
refinement's cg_tol with maxiter 300 and stall 100, as
`test_torch_refine.py` shortens it; one torch thread (the suite's
workers share the cores).  The route of `solve` and of the Refiner, one
camera or the rig, is `kernels.runs_kernels`'s answer, and their kernel
layout `kernels.kernel_layout`'s.  A Refiner step's plain product, one
camera or the rig, f32, f64 or the f64 redo, reaches `rcs.pcg` marked
``capturable`` (its CUDA-graph route on a card), and the extras' wrapped
product unmarked.  ~25 s."""

import numpy as np
import pytest
import torch

from benchmark.reference import bundle as ref_bundle
from benchmark.reference import rig as ref_rig
from bundle_adjustment_tpu_torch import convert, synthetic
from bundle_adjustment_tpu_torch.parallel import (engine, hilo, kernels, lm,
                                                  rcs, refine, solver)
from bundle_adjustment_tpu_torch.solver import tracing
from _torch_threads import one_torch_thread  # noqa: F401

P, M, V = 1000, 20, 12
SOLVE = dict(damping=1e-2, max_iterations=30, tolerance=1e-3)
CONVERGE = dict(tolerance=1e-6, damping=0.0, max_steps=15, cg_maxiter=300,
                stall_limit=100)
#: max|x - x_ref| over every parameter: the port's answer lies ~1e-10 from
#: the reference's optimum, the float32 reference ~1e-3
STATE_TOL = 1e-6
CPU = torch.device("cpu")


def _solve(C):
    """(host problem, host state, spec, f32 problem, `solve`'s result) of
    the witness with C cameras."""
    ph, sh, spec = synthetic.build_problem(P, M, V, seed=0, num_cameras=C)
    p32 = convert.problem_to_torch(ph, CPU, torch.float32)
    s32 = convert.state_to_torch(sh, CPU, torch.float32)
    return ph, sh, spec, p32, solver.solve(p32, s32, spec, **SOLVE)


def _refine(solved):
    """(refined f64 state, Convergence, spans) of the refinement from the
    solve's end."""
    _, _, spec, p32, res = solved
    with tracing.recording(job=0) as spans:
        refiner = refine.Refiner(p32, spec, use_kernels=None,
                                 couple_global=False)
        phase = lm.LMPhase(steps=res.iterations, max_dx=res.max_abs_dx,
                           cg_iterations=[], seconds=0.0)
        s, rec = refine.converge(refiner, (res.state, phase), **CONVERGE)
    return hilo.to_f64(s), rec, list(spans)


def _adjust(C):
    """(host problem, host state, spec, refined f64 state, Convergence,
    spans) of the port's adjustment of the witness with C cameras."""
    solved = _solve(C)
    return (*solved[:3], *_refine(solved))


@pytest.fixture(scope="module")
def rig4():
    return _adjust(4)


def _reference(ph, sh, dtype):
    """The reference's optimum from the truth, on the observations and
    held coordinates as the port gets them (f32)."""
    xy = ph.obs_xy.astype(np.float32).astype(np.float64)
    net = ref_rig.make_net(xy, ph.obs_image, ph.cam_of_image, ph.free_point,
                           P, V, M, ph.r0[0], CPU, dtype)
    pts = synthetic.true_points(P, seed=0)
    pts = np.where(ph.free_point[:P] > 0, pts,
                   pts.astype(np.float32).astype(np.float64))
    start = ref_bundle.make_state(pts, synthetic.true_eo(M), sh.io, sh.dist,
                                  CPU, dtype)
    return ref_rig.gauss_newton(net, start, tolerance=1e-8, max_steps=6)


def _gap(x, y):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(x, y))


def test_refinement_converges_on_a_rig_to_the_reference(rig4):
    ph, sh, _, x, rec, _ = rig4
    assert rec.converged and rec.max_dx[-1] <= 1e-6, rec.max_dx
    assert rec.f64_steps >= 1
    ref = _reference(ph, sh, torch.float64)
    answer = (x.points[:P], x.eo,
              torch.cat([x.io.reshape(-1), x.dist.reshape(-1)]))
    assert _gap(answer, ref.state) <= STATE_TOL
    low = _reference(ph, sh, torch.float32)
    assert _gap(low.state, ref.state) > STATE_TOL


def test_f64_steps_are_traced(rig4):
    """Each f64 inner step is a ``refine.step64`` span inside its
    ``refine.step``, counting its CG iterations; the refinement's CG
    counts are the f32 and f64 solves' together; the compact rows' global
    work is a ``compact.camera_sum`` span in linearise, the reduction and
    the product."""
    *_, rec, spans = rig4
    names = [s.name for s in spans]
    step64 = [s for s in spans if s.name == "refine.step64"]
    assert len(step64) == rec.f64_steps
    assert all(spans[s.parent].name == "refine.step" for s in step64)
    inside = [s for s, m in zip(spans, _within(spans, "refine.step"))
              if m and s.name == "pcg"]
    assert sum(s.counts["iterations"] for s in inside) \
        == sum(rec.cg_iterations)
    f64 = sum(s.counts["iterations"] for s in step64)
    assert 0 < f64 <= sum(rec.cg_iterations)
    parents = {names[s.parent] for s in spans
               if s.name == engine.CAMERA_SUM_SPAN}
    assert {"linearize", "prepare", "pcg"} <= parents


def _within(spans, name):
    out = []
    for s in spans:
        out.append(s.name == name or (s.parent >= 0 and out[s.parent]))
    return out


@pytest.fixture(scope="module")
def one_camera():
    return _solve(1)


def test_one_camera_converges_in_f32(one_camera):
    _, rec, spans = _refine(one_camera)
    assert rec.converged and rec.f64_steps == 0, rec.max_dx
    assert not {"refine.step64", engine.CAMERA_SUM_SPAN} \
        & {s.name for s in spans}


def test_a_failed_f32_cg_is_redone_in_f64(one_camera, monkeypatch):
    """The f32 CG made to return its zero start: the step is redone in
    f64 and the refinement stays there, to the same optimum as the f32
    route's within the tolerance of the stop."""
    pcg = rcs.pcg

    def zero_start_in_f32(rc, rg, *a, **kw):
        if rc.dtype == torch.float32:
            return torch.zeros_like(rc), torch.zeros_like(rg), 0
        return pcg(rc, rg, *a, **kw)

    x32, _, _ = _refine(one_camera)
    monkeypatch.setattr(rcs, "pcg", zero_start_in_f32)
    x, rec, spans = _refine(one_camera)
    assert rec.converged and rec.f64_steps == rec.refine_steps, rec.max_dx
    assert len([s for s in spans if s.name == "refine.step64"]) \
        == rec.refine_steps
    assert _gap(x, x32) <= 1e-5


#: (cameras, scale bars and datum, f32 CG made to fail, the (dtype,
#: ``capturable``) of each product the step hands `rcs.pcg`)
MARKS = {
    "rig_f64": (4, False, False, [(torch.float64, True)]),
    "one_camera_f32": (1, False, False, [(torch.float32, True)]),
    "one_camera_f64_redo": (1, False, True,
                            [(torch.float32, True), (torch.float64, True)]),
    "one_camera_extras": (1, True, False, [(torch.float32, False)]),
    "rig_extras": (4, True, False, [(torch.float64, False)]),
}


@pytest.mark.parametrize("case", sorted(MARKS))
def test_the_refiners_plain_product_is_capturable(case, monkeypatch):
    """The plain product a Refiner step hands `rcs.pcg` is marked
    ``capturable`` (on a card its CG replays as a CUDA graph), in f32 and
    in f64: a rig's inner solve and the f64 redo of a step whose f32 CG
    failed (forced as in `test_a_failed_f32_cg_is_redone_in_f64`).  The
    product `freenet.wrap_matvec` wraps for the extras (scale bars, the
    inner-constraint datum) carries no mark."""
    cameras, extras, fail32, want = MARKS[case]
    ph, sh, spec = synthetic.build_problem(256, 12, 6, seed=1,
                                           num_cameras=cameras)
    if extras:
        ph = synthetic.free_network(ph, sh, bars=2, seed=2)
    p32 = convert.problem_to_torch(ph, CPU, torch.float32)
    s32 = convert.state_to_torch(sh, CPU, torch.float32)
    assert p32.has_extras is extras
    pcg, marks = rcs.pcg, []

    def recorded(rc, rg, Minv, matvec, **kw):
        marks.append((rc.dtype, getattr(matvec, "capturable", False)))
        if fail32 and rc.dtype == torch.float32:
            return torch.zeros_like(rc), torch.zeros_like(rg), 0
        return pcg(rc, rg, Minv, matvec, **kw)

    monkeypatch.setattr(rcs, "pcg", recorded)
    r = refine.Refiner(p32, spec, couple_global=False)
    assert r.use_kernels is False
    r.step(hilo.from_f32(s32), cg_maxiter=20)
    assert marks == want


#: (cameras, use_kernels, on a card, the rule's answer or its error)
ROUTES = [
    (1, None, False, False), (1, None, True, True), (1, False, True, False),
    (1, True, False, True), (1, ("K1", "K2", "K3"), False, True),
    (1, ("K3",), False, "together"), (1, ("K1", "K2"), True, "together"),
    (4, None, False, False), (4, None, True, False), (4, False, True, False),
    (4, True, False, "single-camera"),
    (4, ("K1", "K2", "K3"), True, "single-camera"),
]


@pytest.mark.parametrize("cameras, use_kernels, on_card, answer", ROUTES)
def test_one_rule_routes_solve_and_the_refiner(cameras, use_kernels, on_card,
                                               answer, monkeypatch):
    """`kernels.runs_kernels` decides the point-major route of `solve` and
    of `Refiner`: the kernels by default only for a single-camera f32
    problem on a card, never on a rig (its compact rows), and kernel names
    only all three together.  Both take its answer or raise its error, and
    where they run the kernels both hold the one layout of
    `kernels.kernel_layout`, view-major at `choose_pb`'s block.  "On a
    card": the CPU tensors are handed to the rule as a card's, so the
    routes run the kernels' plain versions."""
    ph, sh, spec = synthetic.build_problem(256, 12, 6, seed=1,
                                           num_cameras=cameras)
    p32 = convert.problem_to_torch(ph, CPU, torch.float32)
    s32 = convert.state_to_torch(sh, CPU, torch.float32)
    device = torch.device("cuda" if on_card else "cpu")
    rule, layout = kernels.runs_kernels, kernels.kernel_layout
    asked, layouts = [], []

    def runs_kernels(problem, use, dtype, dev):
        assert problem is p32 and use == use_kernels and dev == CPU
        asked.append(rule(problem, use, dtype, device))
        return asked[-1]

    def kernel_layout(fmp):
        layouts.append(layout(fmp))
        return layouts[-1]

    monkeypatch.setattr(kernels, "runs_kernels", runs_kernels)
    monkeypatch.setattr(kernels, "kernel_layout", kernel_layout)
    routes = (lambda: solver.solve(p32, s32, spec, max_iterations=1,
                                   use_kernels=use_kernels),
              lambda: refine.Refiner(p32, spec, use_kernels=use_kernels))
    if isinstance(answer, str):
        for route in routes:
            with pytest.raises(ValueError, match=answer):
                route()
        assert not layouts
        return
    routes[0]()
    r = routes[1]()
    assert asked == [answer, answer] and r.use_kernels is answer
    assert len(layouts) == 2 * answer
    if not answer:
        assert r.fmp32.vm_pb is None
        return
    fv, fr = layouts
    assert r.fmp32 is fr and fv.vm_pb == fr.vm_pb == kernels.choose_pb(
        256, 6, 3 + spec.num_coefficients)
    for name, x in fv._asdict().items():
        y = getattr(fr, name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), name
