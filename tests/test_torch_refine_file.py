"""The mixed-precision refinement on the file order (`refine.Refiner` on
the block-layout engine), on the CPU: the port's route for a network of
uneven visibility is `solver.solve` (f32) -> `refine.Refiner` ->
`refine.converge(damping=0)`, as the benchmark's ``adjust_uneven`` job
runs it, on the problem as `convert.problem_to_torch` uploads it, never
padded.

The witness is `synthetic.thin_views(build_problem(800, 24, 16, seed=3),
views=6, every=10)`: every 10th point keeps its 16 views, the others
their first 6, N = 5,600 rows in file order (grouped by image), where
the padded point-major layout would take 12,800 (> 2 N), so
`rcs.choose_layout` gives ``"file"``.  The same network with two
cameras takes the route too (a rig's inner solve in f64 from the first
step, as on the point-major layout).

Tolerances, each with its reason:
* the optimum against the point-major Refiner's on `rcs.to_point_major`
  of the same network, both refined to max|dx| <= 1e-8: every parameter
  within 1e-8 (absolute, tighter than 1e-8 of the 2,000-unit field; the
  two land ~1e-11 apart: one optimum, two CG paths, each stopped a step
  of <= 1e-8 away, which the undamped refinement contracts by 1e-2 or
  more), and the f64 Omega at rtol 1e-9 (it is flat at the optimum: a
  state error d moves it by ~|J d|^2 / Omega, ~1e-13 here);
* `gradient64` against the JAX `rcs.linearize` in f64 on the same
  file-order arrays: rtol 1e-10 per block with an absolute floor of
  1e-10 x the block's largest entry, as `test_torch_refine.py` holds the
  point-major pass (f64 on both sides, other summation orders);
* a step whose f32 CG is made to fail is redone in f64 and lands on the
  f32 route's optimum within 1e-5, as `test_torch_rig_refine.py` holds it.

A point-major refinement keeps its bits: `POINT_MAJOR_DIGEST` was taken
on the Refiner before it took the file order.  CG budget: the
refinement's cg_tol with maxiter 300 and stall 100, as
`test_torch_refine.py` shortens it.  ~35 s."""

import hashlib

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch import convert, synthetic
from bundle_adjustment_tpu_torch.parallel import hilo, lm, rcs, refine
from bundle_adjustment_tpu_torch.parallel import solver
from bundle_adjustment_tpu_torch.solver import tracing
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SHAPE, SEED, VIEWS, EVERY = (800, 24, 16), 3, 6, 10
SOLVE = dict(damping=1e-2, max_iterations=30, tolerance=1e-3)
CONVERGE = dict(tolerance=1e-6, damping=0.0, max_steps=15, cg_maxiter=300,
                stall_limit=100)


def _network(cameras=1):
    """(host problem, host state, spec) of the witness."""
    ph, sh, spec = synthetic.build_problem(*SHAPE, seed=SEED,
                                           num_cameras=cameras)
    ph, sh = synthetic.thin_views(ph, sh, views=VIEWS, every=EVERY)
    return ph, sh, spec


def _solved(cameras):
    """(f32 file-order problem, spec, `lm_result` of its f32 solve)."""
    ph, sh, spec = _network(cameras)
    p32 = convert.problem_to_torch(ph, CPU, torch.float32)
    s32 = convert.state_to_torch(sh, CPU, torch.float32)
    res = solver.solve(p32, s32, spec, **SOLVE)
    phase = lm.LMPhase(steps=res.iterations, max_dx=res.max_abs_dx,
                       cg_iterations=[h["cg_it"] for h in res.history],
                       seconds=0.0)
    return p32, spec, (res.state, phase)


def _converge(problem, spec, lm_result, **kw):
    """(refined f64 state, record, spans, Refiner) of one `converge`
    run."""
    with tracing.recording() as spans:
        r = refine.Refiner(problem, spec, couple_global=False)
        s, rec = refine.converge(r, lm_result, **{**CONVERGE, **kw})
    return hilo.to_f64(s), rec, spans, r


_RUNS = {}


def _refined(cameras):
    """(`_solved`, `_converge` of it with the mix's settings), once per
    module."""
    if cameras not in _RUNS:
        solved = _solved(cameras)
        _RUNS[cameras] = solved, _converge(*solved)
    return _RUNS[cameras]


@pytest.fixture(scope="module", params=[1, 2], ids=["one_camera", "rig2"])
def refined(request):
    return _refined(request.param)


def test_layout_rule_picks_the_file_order():
    ph, _, _ = _network()
    N = ph.obs_point.shape[0]
    assert rcs.choose_layout(ph.obs_point, ph.num_points) == "file"
    assert ph.num_points * SHAPE[2] > 2 * N and ph.point_uniform is None


def test_refiner_converges_on_the_file_order(refined):
    """(a) `solve` -> `Refiner` -> `converge` on the file order reaches
    1e-6 with the problem unpadded, on the block-layout engine; one
    camera in f32, a rig's inner solve in f64."""
    (p32, _, _), (x, rec, spans, r) = refined
    assert rec.converged and rec.max_dx[-1] <= 1e-6, rec.max_dx
    assert r.file_order and r.fmp32 is p32
    assert r.fmp64.obs_xy.dtype == torch.float64
    assert r.fmp64.obs_point.shape == p32.obs_point.shape
    rig = int(p32.r0.shape[0]) > 1
    assert rec.f64_steps == (rec.refine_steps if rig else 0)
    names = {s.name for s in spans}
    assert {"refine.build", "refine.gradient64", "linearize", "prepare",
            "pcg", "back_substitute", "rcs.point_sum",
            "rcs.image_sum"} <= names
    assert x.points.shape == (p32.num_points, 3)


def test_file_order_optimum_is_the_point_major_one(refined):
    """(b) The file order's optimum equals the point-major Refiner's on
    `rcs.to_point_major` of the same network (tolerances in the module
    docstring)."""
    (p32, spec, lm_result), _ = refined
    x, rec, _, r = _converge(p32, spec, lm_result, tolerance=1e-8)
    pm = rcs.to_point_major(p32)
    y, rec_pm, _, r_pm = _converge(pm, spec, lm_result, tolerance=1e-8)
    assert rec.converged and rec_pm.converged
    assert not r_pm.file_order
    for a, b in zip(x, y):
        assert float((a - b).abs().max()) <= 1e-8
    om = float(r.gradient64(r.fmp64, x)[3])
    om_pm = float(r_pm.gradient64(r_pm.fmp64, y)[3])
    assert abs(om / om_pm - 1.0) <= 1e-9


def test_gradient64_matches_jax_linearize():
    """(c) `gradient64` on the file order against the JAX
    `rcs.linearize` in f64 on the same arrays (point sums by
    segment_sum, the blocked image layout)."""
    import jax
    import jax.numpy as jnp

    from bundle_adjustment_tpu.models.distortion import DistortionSpecBuilder
    from bundle_adjustment_tpu.models.problem import ParamState as JState
    from bundle_adjustment_tpu.parallel import rcs as JR

    ph, sh, spec = _network()
    p32 = convert.problem_to_torch(ph, CPU, torch.float32)
    r = refine.Refiner(p32, spec)
    st64 = convert.state_to_torch(sh, CPU, torch.float64)
    got = r.gradient64(r.fmp64, st64)

    builder = DistortionSpecBuilder()  # synthetic.scale_spec's stack
    builder.add_affinity()
    builder.add_tangential()
    for order in (1, 2, 3):
        builder.add_radial_order(order)
    # the observations as the port gets them (f32-rounded), in f64
    fields = ph._replace(
        obs_xy=np.asarray(ph.obs_xy, np.float32).astype(np.float64))
    pj = JR.RCSProblem(**{
        f: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        for f, v in fields._asdict().items() if f in JR.RCSProblem._fields})
    jspec = builder.build()
    bj = jax.jit(lambda st: JR.linearize(pj, st, jspec, 0.0))(
        JState(*(jnp.asarray(a, jnp.float64) for a in sh)))
    for name, a, b in zip(("bp", "bc", "bg", "omega0"),
                          (bj.bp, bj.bc, bj.bg, bj.omega0), got):
        a = np.asarray(a)
        assert b.dtype == torch.float64, name
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-10,
                                   atol=1e-10 * np.max(np.abs(a)),
                                   err_msg=name)
    assert [tuple(x.shape) for x in got[4:]] == [(0,)] * 2


def test_a_failed_f32_cg_is_redone_in_f64(monkeypatch):
    """(d) The f32 CG made to return its zero start: the step is redone
    in f64 on the file order, in a ``refine.step64`` span, and the
    refinement stays there, to the f32 route's optimum."""
    (p32, spec, lm_result), (x32, *_) = _refined(1)
    pcg = rcs.pcg

    def zero_start_in_f32(rc, rg, *a, **kw):
        if rc.dtype == torch.float32:
            return torch.zeros_like(rc), torch.zeros_like(rg), 0
        return pcg(rc, rg, *a, **kw)

    monkeypatch.setattr(rcs, "pcg", zero_start_in_f32)
    x, rec, spans, _ = _converge(p32, spec, lm_result)
    assert rec.converged and rec.f64_steps == rec.refine_steps, rec.max_dx
    assert len([s for s in spans if s.name == "refine.step64"]) \
        == rec.refine_steps
    assert max(float((a - b).abs().max()) for a, b in zip(x, x32)) <= 1e-5


def test_rows_counter_reads_the_file_rows():
    """(e) ``refine.build`` counts the observation rows its problems hold:
    N on the file order, P x V on the point-major layout."""
    ph, _, spec = _network()
    p32 = convert.problem_to_torch(ph, CPU, torch.float32)
    pm = rcs.to_point_major(p32)
    for problem, rows in ((p32, ph.obs_point.shape[0]),
                          (pm, ph.num_points * SHAPE[2])):
        with tracing.recording() as spans:
            refine.Refiner(problem, spec)
        assert [s.counts for s in spans if s.name == "refine.build"] \
            == [{"rows": rows}]


@pytest.mark.parametrize("extra", ["bars", "datum", "group"])
def test_extras_on_the_file_order_raise(extra):
    """(f) Scale bars, the inner-constraint datum and a populated direct
    group on the file order raise ValueError naming the layout."""
    ph, _, spec = _network()
    p32 = convert.problem_to_torch(ph, CPU, torch.float32)
    one, two = torch.ones(1), torch.ones(2)
    i32 = dict(dtype=torch.int32)
    kw = {"bars": dict(sb_a=torch.zeros(1, **i32), sb_b=torch.ones(1, **i32),
                       sb_length=one, sb_weight=one),
          "datum": dict(datum_mask_d=torch.ones(p32.num_points),
                        defect_flags_d=(True,) * 6 + (False,)),
          "group": dict(dpg_idx=torch.tensor([5, 5], **i32),
                        dpg_axis=torch.tensor([0, 1], **i32), dpg_val=two,
                        dpg_cov=torch.eye(2))}[extra]
    p32 = p32._replace(**kw)
    assert p32.has_extras and p32.point_uniform is None
    with pytest.raises(ValueError, match="'file' layout"):
        refine.Refiner(p32, spec)


#: sha256 of the hi and lo state and the CG counts of two point-major
#: refinements (`solve` -> `Refiner` -> `converge`, damping 0) of
#: `build_problem(384, 12, 8, seed=6)`: the plain path with block Jacobi,
#: and the kernels' route (their plain versions on the CPU) with the
#: coupled preconditioner; one CPU thread, taken on the Refiner before it
#: took the file order
POINT_MAJOR_DIGEST = \
    "49813a8a0829884d5c1af9fd6cb8404a048018362c72ea8f55d5f6a3019deb26"


def test_point_major_refinement_keeps_its_bits():
    """(g) On the module's one thread (`_torch_threads`), as the digest
    was taken."""
    ph, sh, spec = synthetic.build_problem(384, 12, 8, seed=6)
    p = convert.problem_to_torch(ph, CPU, torch.float32)
    s = convert.state_to_torch(sh, CPU, torch.float32)
    res = solver.solve(p, s, spec, **SOLVE)
    phase = lm.LMPhase(steps=res.iterations, max_dx=res.max_abs_dx,
                       cg_iterations=[], seconds=0.0)
    h = hashlib.sha256()
    for use_kernels, couple in ((None, False), (True, True)):
        r = refine.Refiner(p, spec, use_kernels=use_kernels,
                           couple_global=couple)
        assert not r.file_order
        st, rec = refine.converge(r, (res.state, phase), damping=0.0,
                                  cg_maxiter=300, stall_limit=100)
        for t in (*st.hi, *st.lo):
            h.update(t.contiguous().numpy().tobytes())
        h.update(str(rec.cg_iterations).encode())
    assert h.hexdigest() == POINT_MAJOR_DIGEST
