"""Multi-camera networks in the port's feature-major engine (the compact
layout: 2 Gp local global rows plus the camera of each observation)
against the JAX package, on the CPU in f64.

Rigs from `bench.build_problem(num_cameras=C)` (image m on camera m % C);
every JAX output is computed once, in the module fixture.  Tolerances:

* compact `linearize` (3 cameras, 256 points): the materialised global
  rows rtol 1e-12, bg / extra_g rtol 1e-9, omega0 rtol 1e-10
  (tests/test_multi_camera.py's); the compact reduction (rc, rg, the
  coupled preconditioner's Scg, Sghat^-1, Minv_c), `schur_matvec` and the
  compact `hxp` rtol 1e-9 with atol 1e-12 x max|reference| (f64, the same
  sums in another order);
* `finish_reduction`'s Scg from the compact rows against the one from the
  materialised rows (the single-camera code path on the masked rows):
  rtol 1e-10, atol 1e-12 x max;
* one LM step on a 16-camera rig (2,000 points, 64 images, damping 1e-4
  as the JAX test's), one distortion slot per camera fixed: rtol 3e-4,
  atol 1e-6 x max (the JAX test's: both f64 PCGs stop at 1e-13 relative,
  which both must reach within the CG budget), the fixed slots exactly 0;
  on the same rig, three `solve` iterations against the JAX package (the
  2-camera case's tolerances) and `cov_direct.cov_all` (rtol 1e-8, see
  the test);
* `solve` on a 4-camera rig (2,000 points, 40 images, 12 views): the
  coupled preconditioner is definite at the first step and indefinite at
  the second, where `solve` takes block Jacobi (its history says so, and
  the step's CG count is the JAX step's within 3); two iterations against
  the JAX `solve` at the 2-camera case's tolerances;
* `omega_at` (4 cameras) rtol 1e-10;
* `cov_direct.cov_all` (2 and 3 cameras) against the JAX `cov_direct` chain:
  rtol 1e-9, atol 1e-9 x max (tests/test_torch_cov_direct.py's);
* `solve` on a 2-camera rig against the JAX `solver.solve`: the same
  iterations, Omega rtol 1e-8, coordinates within 1e-7 of the field
  (tests/test_torch_solver.py's); `refine.converge` and the JAX Refiner
  (block Jacobi, see the test) from the same f32 start to max|dx| <= 1e-6:
  both within 1e-9 of the f64 optimum and of each other
  (tests/test_torch_refine.py's bound); on the 16-camera rig neither
  refinement reaches 1e-6, and the port says so (`Convergence.converged`);
  a step whose CG returns its zero start reads max|dx| inf;
* refusals: ``use_kernels=True`` on a rig raises ValueError wherever the
  kernels would run (`lm_step`, `lm_step_full`, `solve`, the Refiner,
  `kernels.pack_fm`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import CPU, np_
from bundle_adjustment_tpu.models.problem import ParamState as JParamState
from bundle_adjustment_tpu.parallel import cov_direct as CJ
from bundle_adjustment_tpu.parallel import engine as E
from bundle_adjustment_tpu.parallel import hilo as JH
from bundle_adjustment_tpu.parallel import refine as JR
from bundle_adjustment_tpu.parallel import solver as JS
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.parallel import (cov_direct, engine, hilo,
                                                  kernels, lm, rcs, refine,
                                                  solver)
from _torch_threads import one_torch_thread  # noqa: F401

DAMPING = 1e-3
# the 16-camera step: the JAX test's damping (at 10,000 points); at 2,000
# points it takes ~1,000 CG iterations to 1e-13
RIG16_DAMPING = 1e-4
RIG16_CG_MAXITER = 3000
SOLVE_KW = dict(damping=1e-2, max_iterations=40, cg_tol=1e-13,
                cg_maxiter=3000)
# the 16-camera solve: its first three LM iterations (113, 252 and 535
# CG iterations; undamped, the rig's f64 CG needs ~3,000 per step)
RIG16_SOLVE_KW = dict(SOLVE_KW, max_iterations=3)
# the 4-camera rig at 2,000 / 40 / 12: the coupled preconditioner is
# definite at the start and indefinite at the second step
RIG4_SOLVE_KW = dict(SOLVE_KW, max_iterations=2)
# CG iterations a block-Jacobi step may differ by from the JAX step's (the
# two engines sum in other orders; a count near the f64 floor follows it)
CG_SLACK = 3
REFINE_KW = dict(tolerance=1e-6, damping=0.0, cg_tol=1e-12, cg_maxiter=300,
                 stall_limit=100)


def rig(C, P, M, V, seed, dtype=jnp.float64):
    import bench

    return bench.build_problem(P, M, V, dtype, seed=seed, num_cameras=C)


def to_port(problem, state, dtype=torch.float64):
    return (convert.problem_to_torch(problem, CPU, dtype),
            convert.state_to_torch(state, CPU, dtype))


def close(a, ref, rtol, atol_of_max=0.0, name=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np_(a), ref, rtol=rtol,
                               atol=atol_of_max * np.max(np.abs(ref)),
                               err_msg=name)


def _fix_last_slot(problem, C, Gp):
    fg = np.asarray(problem.free_global).copy()
    fg[np.arange(C) * Gp + (Gp - 1)] = 0.0
    return problem._replace(free_global=fg)


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX output of this file, computed once."""
    out = {}
    # 3-camera rig: linearise, reduce, matvec, hxp, dense covariance
    problem, state, spec = rig(3, 256, 12, 6, seed=11)
    fj = E.fm_problem(problem)
    bj = E.linearize(fj, state, spec, jnp.asarray(DAMPING))
    bm = E.materialize_global_rows(fj, bj)
    red = E.reduce_blocks(fj, bj, state, jnp.asarray(DAMPING),
                          couple_global=True)
    rng = np.random.default_rng(0)
    G = problem.free_global.shape[0]
    x = dict(xc=rng.normal(size=(12, 6)), xg=rng.normal(size=G),
             v=rng.normal(size=(problem.num_points, 3)))
    b0 = E.linearize(fj, state, spec, jnp.asarray(0.0))
    S = CJ.assemble_reduced_dense(fj, b0)
    out["rig3"] = dict(
        problem=problem, state=state, spec=spec, b=bj, bm=bm, red=red, x=x,
        matvec=E.schur_matvec(fj, red[0], jnp.asarray(x["xc"]),
                              jnp.asarray(x["xg"])),
        hxp=E.point_ops(fj, bj).hxp(jnp.asarray(x["v"])),
        cov=CJ.point_covariance_dense(fj, b0, CJ.reduced_inverse(S)))

    # 16-camera rig, one distortion slot per camera fixed: one LM step
    problem, state, spec = rig(16, 2000, 64, 6, seed=11)
    problem = _fix_last_slot(problem, 16, 3 + spec.num_coefficients)
    f16 = E.fm_problem(problem)
    step = jax.jit(lambda st: E.lm_step(
        f16, st, spec, jnp.asarray(RIG16_DAMPING), cg_tol=1e-13,
        cg_maxiter=RIG16_CG_MAXITER))(state)
    b16 = E.linearize(f16, state, spec, jnp.asarray(0.0))
    out["rig16"] = dict(
        problem=problem, state=state, spec=spec, step=step[:3],
        cg_it=int(step[4]),
        solve=JS.solve(problem, state, spec, **RIG16_SOLVE_KW),
        cov=CJ.point_covariance_dense(f16, b16, CJ.reduced_inverse(
            CJ.assemble_reduced_dense(f16, b16))))

    # 4-camera rig: omega_at
    problem, state, spec = rig(4, 256, 16, 6, seed=5)
    f4 = E.fm_problem(problem)
    b4 = E.linearize(f4, state, spec, jnp.asarray(0.0))
    rng = np.random.default_rng(2)
    dx = (rng.normal(0, 1e-4, (problem.num_points, 3)),
          rng.normal(0, 1e-5, (problem.num_images, 6)),
          rng.normal(0, 1e-6, problem.free_global.shape[0]))
    out["rig4"] = dict(problem=problem, state=state, spec=spec, dx=dx,
                       omega=float(E.omega_at(f4, b4, *map(jnp.asarray,
                                                            dx))))

    # 4-camera rig at 2,000 / 40 / 12: solve (f64), two iterations
    problem, state, spec = rig(4, 2000, 40, 12, seed=4)
    out["rig4_solve"] = dict(problem=problem, state=state, spec=spec,
                             solve=JS.solve(problem, state, spec,
                                            **RIG4_SOLVE_KW))

    # 2-camera rig: solve (f64)
    problem, state, spec = rig(2, 256, 12, 6, seed=4)
    f2 = E.fm_problem(problem)
    b2 = E.linearize(f2, state, spec, jnp.asarray(0.0))
    Q2 = CJ.reduced_inverse(CJ.assemble_reduced_dense(f2, b2))
    out["rig2"] = dict(problem=problem, state=state, spec=spec,
                       solve=JS.solve(problem, state, spec, **SOLVE_KW),
                       cov=CJ.point_covariance_dense(f2, b2, Q2))

    # 2- and 16-camera rigs in f32: the Refiner (block Jacobi) from the
    # port's f32 LM phase's end
    for key, C, P, M, V in (("rig2_f32", 2, 512, 16, 8),
                            ("rig16_f32", 16, 2000, 64, 6)):
        problem32, state32, spec = rig(C, P, M, V, seed=4,
                                       dtype=jnp.float32)
        p32, s32 = to_port(problem32, state32, torch.float32)
        st32, _ = lm.run(engine.fm_problem(p32), s32, spec,
                         use_kernels=False)
        rj = JR.Refiner(problem32, spec, couple_global=False)
        sj, hist_j = rj.refine(
            JParamState(*(jnp.asarray(np_(a)) for a in st32)),
            max_iterations=12, **REFINE_KW)
        out[key] = dict(spec=spec, p32=p32, st32=st32,
                        refined=(JH.to_f64(sj), hist_j))
    return out


# ---- linearise, reduction, matvec ------------------------------------------


def test_compact_linearize_matches_jax(jax_side):
    r = jax_side["rig3"]
    pt, st = to_port(r["problem"], r["state"])
    ft = engine.fm_problem(pt)
    bt = engine.linearize(ft, st, r["spec"], DAMPING)
    assert bt.Jg is None and bt.PJg is None and len(bt.Jg_loc) == 2 * 10
    bm = engine.materialize_global_rows(ft, bt)
    G = r["problem"].free_global.shape[0]
    assert len(bm.Jg) == 2 * G == 2 * 3 * 10
    for name in ("Jg", "PJg"):
        for a, ref in zip(getattr(bm, name), getattr(r["bm"], name)):
            close(a, ref, 1e-12, name=name)
    close(bt.bg, r["b"].bg, 1e-9, 1e-12, "bg")
    close(bt.extra_g, r["b"].extra_g, 1e-9, 1e-12, "extra_g")
    close(bt.omega0, r["b"].omega0, 1e-10, name="omega0")


def test_compact_reduction_and_matvec_match_jax(jax_side):
    r = jax_side["rig3"]
    pt, st = to_port(r["problem"], r["state"])
    ft = engine.fm_problem(pt)
    b, rc, rg, Minv = engine.prepare(ft, st, r["spec"], DAMPING,
                                     couple_global=True)
    bj, rcj, rgj, Mj = r["red"]
    for name, a, ref in (("rc", rc, rcj), ("rg", rg, rgj),
                         ("extra_c", b.extra_c, bj.extra_c),
                         ("Scg", Minv.Scg, Mj.Scg),
                         ("Minv_c", Minv.Minv_c, Mj.Minv_c),
                         ("Sghat_inv", Minv.Sghat_inv, Mj.Sghat_inv)):
        close(a, ref, 1e-9, 1e-12, name)
    x = r["x"]
    out = engine.schur_matvec(ft, b, torch.as_tensor(x["xc"]),
                              torch.as_tensor(x["xg"]))
    for a, ref in zip(out, r["matvec"]):
        close(a, ref, 1e-9, 1e-12, "matvec")
    # a leading rhs axis gives each rhs's own product
    xc = torch.stack([torch.as_tensor(x["xc"]), -2.0 * torch.as_tensor(
        x["xc"])])
    xg = torch.stack([torch.as_tensor(x["xg"]), torch.zeros(len(x["xg"]),
                                                            dtype=xc.dtype)])
    oc, og = engine.schur_matvec(ft, b, xc, xg)
    for i in range(2):
        one = engine.schur_matvec(ft, b, xc[i], xg[i])
        close(oc[i], np_(one[0]), 1e-12, 1e-14)
        close(og[i], np_(one[1]), 1e-12, 1e-14)


def test_compact_hxp_matches_jax(jax_side):
    r = jax_side["rig3"]
    pt, st = to_port(r["problem"], r["state"])
    ft = engine.fm_problem(pt)
    bt = engine.linearize(ft, st, r["spec"], DAMPING)
    oc, og = engine.point_ops(ft, bt).hxp(torch.as_tensor(r["x"]["v"]))
    close(oc, r["hxp"][0], 1e-9, 1e-12, "Hcp v")
    close(og, r["hxp"][1], 1e-9, 1e-12, "Hgp v")


def test_scg_matches_the_materialized_rows(jax_side):
    """`finish_reduction`'s Scg from the compact rows (local Hcg columns
    expanded per camera minus `_scg_correction`) equals the one the
    single-camera code path forms from the masked rows."""
    r = jax_side["rig3"]
    pt, st = to_port(r["problem"], r["state"])
    ft = engine.fm_problem(pt)
    bt = engine.linearize(ft, st, r["spec"], DAMPING)
    compact = engine.reduce_blocks(ft, bt, st, DAMPING, couple_global=True)
    masked = engine.reduce_blocks(
        ft, engine.materialize_global_rows(ft, bt)._replace(Jg_loc=None,
                                                            PJg_loc=None),
        st, DAMPING, couple_global=True)
    close(compact[3].Scg, np_(masked[3].Scg), 1e-10, 1e-12, "Scg")
    close(compact[3].Sghat_inv, np_(masked[3].Sghat_inv), 1e-9, 1e-12)
    close(compact[2], np_(masked[2]), 1e-10, 1e-12, "rg")


def test_compact_step_matches_jax_16cam_rig(jax_side):
    r = jax_side["rig16"]
    pt, st = to_port(r["problem"], r["state"])
    dxp, dxc, dxg, b, it = engine.lm_step(
        engine.fm_problem(pt), st, r["spec"], RIG16_DAMPING, cg_tol=1e-13,
        cg_maxiter=RIG16_CG_MAXITER)
    assert b.Jg is None
    # both PCGs reached their tolerance
    assert max(it, r["cg_it"]) < RIG16_CG_MAXITER
    for a, ref in zip((dxp, dxc, dxg), r["step"]):
        close(a, ref, 3e-4, 1e-6)
    Gp = 3 + r["spec"].num_coefficients
    np.testing.assert_array_equal(np_(dxg)[np.arange(16) * Gp + Gp - 1], 0.0)


def test_solve_on_a_16cam_rig_matches_jax(jax_side):
    r = jax_side["rig16"]
    pt, st = to_port(r["problem"], r["state"])
    res = solver.solve(pt, st, r["spec"], **RIG16_SOLVE_KW)
    ref = r["solve"]
    assert res.iterations == ref.iterations == 3
    assert res.status == ref.status
    np.testing.assert_allclose(res.omega, ref.omega, rtol=1e-8)
    close(res.state.points, ref.state.points, 0.0, 1e-7, "points")
    close(res.state.io, ref.state.io, 1e-7, name="io")


def test_cov_all_matches_jax_on_a_16cam_rig(jax_side):
    """rtol 1e-8: the Jacobi-scaled S of this rig has condition ~1e8
    (~1.3e7 for the 3-camera rig held at 1e-9), so two f64 inverses in
    other orders differ by ~3e-9 relative."""
    r = jax_side["rig16"]
    pt, st = to_port(r["problem"], r["state"])
    Q = cov_direct.cov_all(engine.fm_problem(pt), st, r["spec"])
    close(Q, r["cov"], 1e-8, 1e-9, "cov_all")


def test_compact_omega_matches_jax(jax_side):
    r = jax_side["rig4"]
    pt, st = to_port(r["problem"], r["state"])
    ft = engine.fm_problem(pt)
    b = engine.linearize(ft, st, r["spec"], 0.0)
    om = engine.omega_at(ft, b, *(torch.as_tensor(d) for d in r["dx"]))
    np.testing.assert_allclose(float(om), r["omega"], rtol=1e-10)


def test_cov_all_matches_jax_on_a_rig(jax_side):
    r = jax_side["rig3"]
    pt, st = to_port(r["problem"], r["state"])
    Q = cov_direct.cov_all(engine.fm_problem(pt), st, r["spec"])
    close(Q, r["cov"], 1e-9, 1e-9, "cov_all")


def test_cov_all_matches_jax_on_a_2cam_rig(jax_side):
    r = jax_side["rig2"]
    pt, st = to_port(r["problem"], r["state"])
    Q = cov_direct.cov_all(engine.fm_problem(pt), st, r["spec"])
    close(Q, r["cov"], 1e-9, 1e-9, "cov_all")


# ---- solve and refinement --------------------------------------------------


def test_solve_on_a_rig_matches_jax(jax_side):
    r = jax_side["rig2"]
    pt, st = to_port(r["problem"], r["state"])
    res = solver.solve(pt, st, r["spec"], **SOLVE_KW)
    ref = r["solve"]
    assert res.converged and ref.converged
    assert res.iterations == ref.iterations
    np.testing.assert_allclose(res.omega, ref.omega, rtol=1e-8)
    pj = np.asarray(ref.state.points)
    close(res.state.points, pj, 0.0, 1e-7, "points")
    close(res.state.io, ref.state.io, 1e-7, name="io")
    # each camera's principal distance lies at its own true value
    io_true = np.array([-30.0, -29.7])
    assert np.all(np.abs(np_(res.state.io)[:, 2] - io_true) < 1e-2)


def test_solve_takes_block_jacobi_where_the_coupling_is_indefinite(
        jax_side):
    r = jax_side["rig4_solve"]
    pt, st = to_port(r["problem"], r["state"])
    res = solver.solve(pt, st, r["spec"], **RIG4_SOLVE_KW)
    ref = r["solve"]
    assert [h["precond"] for h in res.history] == ["coupled", "block_jacobi"]
    assert res.iterations == ref.iterations == 2
    # the block-Jacobi step is the JAX step's
    assert abs(res.history[1]["cg_it"] - ref.history[1]["cg_it"]) <= CG_SLACK
    np.testing.assert_allclose(res.omega, ref.omega, rtol=1e-8)
    close(res.state.points, ref.state.points, 0.0, 1e-7, "points")
    close(res.state.io, ref.state.io, 1e-7, name="io")


def _f64_optimum(p32, st32, spec, steps=8):
    """f64 Gauss-Newton on the same (f32-rounded) observations."""
    fmp64 = engine.fm_problem(refine.upcast_problem(p32))
    ref = st32._replace(**{k: v.double() for k, v in st32._asdict().items()})
    for _ in range(steps):
        dxp, dxc, dxg, _, _ = engine.lm_step(fmp64, ref, spec, 0.0,
                                             cg_tol=1e-13, cg_maxiter=2000)
        ref, mdx = rcs.apply_step(ref, dxp, dxc, dxg)
    assert float(mdx) < 1e-10
    return ref


def test_converge_on_a_rig_matches_jax(jax_side):
    """`refine.converge` (undamped) and the JAX Refiner from the same f32
    start, both with the block-Jacobi preconditioner
    (``couple_global=False``; the coupled one drops the camera-camera
    blocks and is indefinite on rigs, `PERF.md`): both reach max|dx| <=
    1e-6 and end on the f64 optimum of the same f32-rounded problem, and
    on each other."""
    r = jax_side["rig2_f32"]
    p32, st32, spec = r["p32"], r["st32"], r["spec"]
    ref = _f64_optimum(p32, st32, spec)
    with pytest.raises(ValueError, match="single-camera"):
        refine.Refiner(p32, spec, use_kernels=True)
    rt = refine.Refiner(p32, spec, couple_global=False)
    phase = lm.LMPhase(steps=0, max_dx=0.0, cg_iterations=[], seconds=0.0)
    s, rec = refine.converge(rt, (st32, phase), **REFINE_KW)
    full_j, hist_j = r["refined"]
    pts = np_(ref.points)
    scale = np.abs(pts).max()
    full = hilo.to_f64(s)
    assert rec.converged and rec.max_dx[-1] <= 1e-6 and hist_j[-1] <= 1e-6
    assert np.abs(np_(full.points) - pts).max() / scale < 1e-9
    assert np.abs(np_(full_j.points) - pts).max() / scale < 1e-9
    assert np.abs(np_(full.points) - np.asarray(full_j.points)).max() \
        / scale < 1e-9
    assert np.abs(np_(full.io) - np.asarray(full_j.io)).max() < 1e-9


def test_converge_on_a_16cam_rig_reports_no_convergence(jax_side):
    """On the 16-camera rig neither the JAX Refiner (its f32 inner solve
    does not contract: the rig's weakest mode) nor the port (a rig's
    inner solve runs in f64, `refine.Refiner`) reaches max|dx| <= 1e-6 in
    12 steps at this CG budget (300 iterations, where the rig's f64 steps
    need ~3,000), and the port's record says so, whether it ran out of
    steps or a step's CG failed."""
    r = jax_side["rig16_f32"]
    rt = refine.Refiner(r["p32"], r["spec"], couple_global=False)
    phase = lm.LMPhase(steps=0, max_dx=0.0, cg_iterations=[], seconds=0.0)
    _, rec = refine.converge(rt, (r["st32"], phase), max_steps=12,
                             **REFINE_KW)
    _, hist_j = r["refined"]
    assert not rec.converged and rec.max_dx[-1] > 1e-6
    assert rec.refine_steps == 12 or np.isinf(rec.max_dx[-1])
    assert hist_j[-1] > 1e-6


def test_a_failed_cg_is_no_convergence(jax_side):
    """A refinement step whose CG returns its zero start on a nonzero
    right-hand side (here: no iteration allowed; on a rig the inner solve
    is f64's, `refine.Refiner`) solved nothing: max|dx| reads inf, the
    cameras and globals do not move (the points take their
    back-substituted step), and `converge` stops unconverged."""
    r = jax_side["rig2_f32"]
    rt = refine.Refiner(r["p32"], r["spec"], couple_global=False)
    phase = lm.LMPhase(steps=0, max_dx=0.0, cg_iterations=[], seconds=0.0)
    s, rec = refine.converge(rt, (r["st32"], phase),
                             **dict(REFINE_KW, cg_maxiter=0))
    assert rec.max_dx == [float("inf")] and rec.cg_iterations == [0]
    assert not rec.converged and rec.f64_steps == 1
    end = hilo.to_f64(s)
    for name in ("eo", "io", "dist"):
        assert torch.equal(getattr(end, name),
                           getattr(r["st32"], name).double()), name


# ---- refusals --------------------------------------------------------------


def test_kernels_refuse_compact_blocks(jax_side):
    r = jax_side["rig3"]
    pt, st = to_port(r["problem"], r["state"], torch.float32)
    ft = engine.fm_problem(pt)
    with pytest.raises(ValueError, match="single-camera"):
        engine.lm_step(ft, st, r["spec"], 1e-2, use_kernels=True)
    with pytest.raises(ValueError, match="single-camera"):
        engine.lm_step_full(ft, pt, st, r["spec"], 1e-2, use_kernels=True)
    with pytest.raises(ValueError, match="single-camera"):
        solver.solve(pt, st, r["spec"], use_kernels=True, max_iterations=1)
    b = engine.linearize(ft, st, r["spec"], 1e-2)
    fv = engine.to_view_major(ft, 128)
    with pytest.raises(ValueError, match="single-camera packed rows"):
        kernels.pack_fm(b, fv)
    # on the CPU the default route is the plain path, and so on the card
    # for more than one camera
    res = solver.solve(pt, st, r["spec"], max_iterations=2,
                       tolerance=1e-3)
    assert res.iterations == 2 and np.isfinite(res.omega)
    assert np_(engine.fm_problem(pt).cam_of_image).tolist() == \
        (np.arange(12) % 3).tolist()
