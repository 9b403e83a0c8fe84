"""The port's mixed-precision refinement (parallel/refine.py) against the
JAX `parallel/refine.py` and an f64 reference solve, on the CPU.

Tolerances:
* `gradient64`: rtol 1e-10 per block (f64 on both sides, other summation
  order), with an absolute floor of 1e-10 x the block's largest entry for
  the entries that are zero (fixed parameters) or nearly cancel;
* `point_ops` products: rtol 1e-12 (f64, identical rows on both sides,
  the same products in another order);
* the refinement, as tests/test_refine.py:14-57 bounds it: max|dx| of the
  last step <= 1e-7, points within 1e-9 of their scale of the f64
  reference optimum, eo within 1e-6, and the error 1e-4 x below the f32
  floor.  The JAX Refiner from the same f32 start must land on the same
  optimum within the same bounds.  Single f32 steps are not compared value
  for value: f32 CG is ill-posed (tests/test_torch_slice.py);
* with extras (scale bars, the inner-constraint datum, a populated direct
  group, diagonal direct observations): `gradient64`'s six outputs at the
  same rtol 1e-10 against the JAX Refiner's; the refinement as
  tests/test_refine.py:80-132 bounds it at 384 / 16 / 8: max|dx| <= 1e-7
  and inter-point distances at rtol 1e-8 against the all-f64 optimum (from
  the port's f64 `lm_step_full`, which tests/test_torch_freenet.py holds
  against JAX).  The f64 Omega is held within 1e-6 (relative) of the
  optimum's, not the 1e-9 of that JAX test: with bars of weight 1e6 the
  refinement floors at max|dx| 2-5e-8, and a state error of 5e-8 under
  such a bar is worth 1e6 x (5e-8)^2 = 2.5e-9 of Omega ~ 1.2e-3.  Omega
  was seen to wander up to 7e-8 (relative) above the optimum from step to
  step and from run to run (the f32 sums depend on the thread count), in
  the port and in the JAX Refiner alike (the JAX run from the same start
  is one of the cases here, under the same bound);
* `converge` from `synthetic.build_problem`, with the bench's damping
  (1e-7) and undamped: max|dx| <= 1e-6 within 15 steps and sigma0 within
  5% of the injected 5e-4 (dof ~ 3.3k here); the undamped run needs no
  more steps than the damped one (the damping bounds the contraction of
  the weakest mode, see `refine.converge`).  The bench's cg_tol, with a
  shorter CG budget (maxiter 300, stall 100) to keep the CPU test short;
  `chip_smoke.py` runs the bench's own settings at full size.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import CPU, blocks_to_torch, build_pair, np_
from bundle_adjustment_tpu.models.problem import ParamState as JParamState
from bundle_adjustment_tpu.parallel import engine as E
from bundle_adjustment_tpu.parallel import hilo as JH
from bundle_adjustment_tpu.parallel import refine as JR
from bundle_adjustment_tpu_torch import convert, synthetic
from bundle_adjustment_tpu_torch.models.problem import ParamState
from bundle_adjustment_tpu_torch.parallel import engine as TE
from bundle_adjustment_tpu_torch.parallel import hilo, kernels, lm, rcs, refine


@pytest.fixture(scope="module")
def pair32():
    pr = build_pair(256, 12, 6, seed=4, f64=False)
    prob_t = convert.problem_to_torch(pr.problem_j, CPU, torch.float32)
    return pr, prob_t


def _to_jax(st):
    return JParamState(*(jnp.asarray(np_(a)) for a in st))


def test_gradient64_matches_jax(pair32):
    pr, prob_t = pair32
    rj = JR.Refiner(pr.problem_j, pr.spec)
    rt = refine.Refiner(prob_t, pr.spec, use_kernels=True)
    assert rt.fmp64.vm_pb is None and rt.fmp64.obs_x.dtype == torch.float64
    st64 = ParamState(*(a.double() for a in pr.state_t))
    gj = rj.gradient64(rj.fmp64, _to_jax(st64))
    gt = rt.gradient64(rt.fmp64, st64)
    for name, a, b in zip(("bp", "bc", "bg", "omega0"), gj[:4], gt):
        a = np.asarray(a)
        assert b.dtype == torch.float64, name
        np.testing.assert_allclose(np_(b), a, rtol=1e-10,
                                   atol=1e-10 * np.max(np.abs(a)),
                                   err_msg=name)


def test_point_ops_match_jax():
    pr = build_pair(256, 12, 6, seed=8)
    bj = E.linearize(pr.fj, pr.state_j, pr.spec, jnp.asarray(1e-3))
    bt = blocks_to_torch(bj)
    oj, ot = E.point_ops(pr.fj, bj), TE.point_ops(pr.ft, bt)
    rng = np.random.default_rng(0)
    v = rng.normal(0, 1, (pr.ft.num_points, 3))
    xc = rng.normal(0, 1, (pr.ft.num_images, 6))
    xg = rng.normal(0, 1, (bt.bg.shape[0],))
    idx = np.array([0, 5, 17, 255])
    pairs = [(oj.hinv(jnp.asarray(v)), ot.hinv(torch.as_tensor(v))),
             (oj.hinv_at(jnp.asarray(idx)), ot.hinv_at(torch.as_tensor(idx))),
             (oj.hpx(jnp.asarray(xc), jnp.asarray(xg)),
              ot.hpx(torch.as_tensor(xc), torch.as_tensor(xg))),
             *zip(oj.hxp(jnp.asarray(v)), ot.hxp(torch.as_tensor(v)))]
    for a, b in pairs:
        np.testing.assert_allclose(np_(b), np.asarray(a), rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(np.asarray(a))))


@pytest.fixture(scope="module")
def f32_start(pair32):
    """(f64 reference optimum, f32 LM phase's end, its point error)."""
    pr, prob_t = pair32
    spec = pr.spec
    # f64 reference optimum on the same (f32-rounded) observations
    fmp64 = TE.fm_problem(refine.upcast_problem(prob_t))
    st = ParamState(*(a.double() for a in pr.state_t))
    for _ in range(14):
        dxp, dxc, dxg, _, _ = TE.lm_step(fmp64, st, spec, 1e-8, cg_tol=1e-13,
                                         cg_maxiter=2000)
        st, mdx = rcs.apply_step(st, dxp, dxc, dxg)
    assert float(mdx) < 1e-10

    # f32 LM phase to its floor, through the kernel path (plain on the CPU)
    s32, damp = pr.state_t, 1e-2
    for _ in range(12):
        dxp, dxc, dxg, _, _ = TE.lm_step(pr.ft, s32, spec, damp, cg_tol=1e-5,
                                         cg_maxiter=200, use_kernels=True)
        a = lm.step_scale(damp)
        s32, _ = rcs.apply_step(s32, a * dxp, a * dxc, a * dxg)
        damp = 0.0 if damp < 1e-9 else damp * 0.2
    err32 = np.abs(np_(s32.points).astype(np.float64)
                   - np_(st.points)).max()
    return st, s32, err32


def _assert_f64_grade(hist, full, ref, err32):
    ref_pts = np_(ref.points)
    assert hist[-1] <= 1e-7, hist
    err = np.abs(np_(full.points) - ref_pts).max()
    assert err < 1e-4 * err32
    assert err / float(np.abs(ref_pts).max()) < 1e-9
    assert np.abs(np_(full.eo) - np_(ref.eo)).max() < 1e-6


def test_refinement_reaches_f64_grade_like_jax(pair32, f32_start):
    pr, prob_t = pair32
    ref, s32, err32 = f32_start
    kernels.reset_launch_counts()
    rt = refine.Refiner(prob_t, pr.spec, use_kernels=True)
    s, history = rt.refine(s32, tolerance=1e-7, max_iterations=12)
    assert set(kernels.launch_counts().values()) == {0}  # CPU: plain
    rj = JR.Refiner(pr.problem_j, pr.spec, use_pallas=False)
    sj, history_j = rj.refine(_to_jax(s32), tolerance=1e-7, max_iterations=12)
    _assert_f64_grade(history, hilo.to_f64(s), ref, err32)
    _assert_f64_grade(history_j, JH.to_f64(sj), ref, err32)


def test_plain_path_refinement_reaches_f64_grade(pair32, f32_start):
    """``use_kernels=False``: the point-major f32 problem and the plain
    `engine.prepare` (coupled preconditioner) land on the same optimum."""
    pr, prob_t = pair32
    ref, s32, err32 = f32_start
    rt = refine.Refiner(prob_t, pr.spec, use_kernels=False)
    assert rt.fmp32.vm_pb is None
    s, history = rt.refine(s32, tolerance=1e-7, max_iterations=12)
    _assert_f64_grade(history, hilo.to_f64(s), ref, err32)


def test_converge_from_synthetic_reaches_tolerance():
    prob_h, state_h, spec = synthetic.build_problem(256, 12, 8, seed=1)
    prob = convert.problem_to_torch(prob_h, CPU, torch.float32)
    st = convert.state_to_torch(state_h, CPU, torch.float32)
    fmp = TE.fm_problem(prob)
    fv = TE.to_view_major(fmp, kernels.choose_pb(
        fmp.num_points, fmp.views, fmp.free_global.shape[0]))
    lm_result = lm.run(fv, st, spec)
    refiner = refine.Refiner(prob, spec, use_kernels=True)
    prob64 = convert.problem_to_torch(prob_h, CPU, torch.float64)
    fmp64 = TE.fm_problem(prob64)
    n = 2 * int((prob64.obs_weight[:, 0, 0] > 0).sum())
    u = int(prob64.free_point.sum() + prob64.free_eo.sum()
            + prob64.free_global.sum())
    steps = {}
    for damping in (1e-7, 0.0):
        s, rec = refine.converge(refiner, lm_result, damping=damping,
                                 cg_maxiter=300, stall_limit=100)
        assert rec.max_dx[-1] <= 1e-6 and rec.refine_steps <= 15, rec
        assert rec.f32_steps == lm_result[1].steps
        assert len(rec.cg_iterations) == rec.refine_steps
        assert all(0 < it <= 300 for it in rec.cg_iterations)
        assert rec.time_to_converged_s == (rec.f32_seconds
                                           + rec.refine_seconds)
        b = TE.linearize(fmp64, hilo.to_f64(s), spec, 0.0)
        s0 = (float(b.omega0) / (n - u)) ** 0.5
        assert abs(s0 / synthetic.SIGMA - 1.0) < 0.05
        steps[damping] = rec.refine_steps
    assert steps[0.0] <= steps[1e-7], steps


def test_refiner_refuses_extras(pair32):
    """The constructor refuses what `convert` refuses (the visibility
    tables of the block-layout engine, more than one camera); scale bars,
    a Helmert datum and direct observations it now takes."""
    _, prob_t = pair32
    problem = SimpleNamespace(**prob_t._asdict(),
                              point2obs=np.zeros((1, 1), np.int32))
    with pytest.raises(NotImplementedError, match="point2obs"):
        refine.Refiner(problem, None)
    with pytest.raises(NotImplementedError, match="single-camera"):
        refine.Refiner(prob_t._replace(r0=torch.ones(2)), None)
    bars = prob_t._replace(
        sb_a=torch.zeros(1, dtype=torch.int32),
        sb_b=torch.ones(1, dtype=torch.int32), sb_length=torch.ones(1),
        sb_weight=torch.ones(1))
    assert refine.Refiner(bars, None).problem64.sb_length.dtype \
        == torch.float64


# ---------------------------------------------------------------------------
# the Refiner's extras
# ---------------------------------------------------------------------------

def _extras_network(P, M, V, seed, **kw):
    """(JAX f32 RCSProblem, port f32 RCSProblem, port f32 state, spec) of
    a bench network re-dressed by `synthetic.free_network(**kw)`."""
    import bench

    problem, state, spec = bench.build_problem(P, M, V, jnp.float32,
                                               seed=seed)
    problem = synthetic.free_network(problem, state, seed=seed + 1, **kw)
    return (problem, convert.problem_to_torch(problem, CPU, torch.float32),
            convert.state_to_torch(state, CPU, torch.float32), spec)


def _assert_distances(pa, pr):
    """Inter-point distances (datum invariants) at rtol 1e-8."""
    ia = np.arange(0, 380, 37)
    np.testing.assert_allclose(np.linalg.norm(pa[ia] - pa[ia + 3], axis=1),
                               np.linalg.norm(pr[ia] - pr[ia + 3], axis=1),
                               rtol=1e-8)


def test_gradient64_with_extras_matches_jax():
    pj, pt, st, spec = _extras_network(
        256, 12, 6, 4, bars=3, direct=dict(group=7, dp=15, de=3, dg=True))
    rj = JR.Refiner(pj, spec)
    rt = refine.Refiner(pt, spec)
    st64 = ParamState(*(a.double() for a in st))
    gj = rj.gradient64(rj.fmp64, _to_jax(st64))
    gt = rt.gradient64(rt.fmp64, st64)
    assert len(gt) == len(gj) == 6
    assert gt[4].shape == (3,) and gt[5].shape == (7,)
    for name, a, b in zip(("bp", "bc", "bg", "omega0", "wsb", "wdpg"), gj, gt):
        a = np.asarray(a)
        assert b.dtype == torch.float64, name
        np.testing.assert_allclose(np_(b), a, rtol=1e-10,
                                   atol=1e-10 * np.max(np.abs(a)),
                                   err_msg=name)
    # without extras the two misclosure vectors are empty
    plain = refine.Refiner(pt._replace(sb_a=None, dpg_idx=None), spec)
    assert [tuple(x.shape) for x in plain.gradient64(plain.fmp64,
                                                     st64)[4:]] == [(0,)] * 2


@pytest.mark.parametrize("case,use_kernels", [
    ("free_network", True), ("free_network", False), ("direct", True)])
def test_refinement_with_extras_reaches_the_f64_optimum(case, use_kernels):
    kw = dict(bars=2) if case == "free_network" else dict(
        bars=1, datum=False, direct=dict(group=9, dp=20, de=4, dg=True))
    pj, prob32, st32, spec = _extras_network(384, 16, 8, 7, **kw)
    assert prob32.has_extras
    prob64 = refine.upcast_problem(prob32)
    fmp64 = TE.fm_problem(prob64)

    # the all-f64 optimum on the same (f32-rounded) observations
    st = ParamState(*(a.double() for a in st32))
    for _ in range(16):
        dxp, dxc, dxg, b64, _, ext64 = TE.lm_step_full(
            fmp64, prob64, st, spec, 1e-8, cg_tol=1e-13, cg_maxiter=3000)
        st, mdx = rcs.apply_step(st, dxp, dxc, dxg)
    assert float(mdx) < 1e-9
    zero = [torch.zeros_like(x) for x in (dxp, dxc, dxg)]
    om_ref = float(TE.omega_at_full(fmp64, prob64, b64, ext64, *zero, st))

    # f32 LM phase to its floor
    fmp32 = TE.fm_problem(prob32)
    s32, damp = st32, 1e-2
    for _ in range(12):
        dxp, dxc, dxg, _, _, _ = TE.lm_step_full(
            fmp32, prob32, s32, spec, damp, cg_tol=1e-5, cg_maxiter=300)
        a = lm.step_scale(damp)
        s32, _ = rcs.apply_step(s32, a * dxp, a * dxc, a * dxg)
        damp = 0.0 if damp < 1e-9 else damp * 0.2

    if case == "free_network" and use_kernels:
        # the JAX Refiner from the same f32 start, under the same bounds
        rj = JR.Refiner(pj, spec)
        sj, history_j = rj.refine(_to_jax(s32), tolerance=1e-7,
                                  max_iterations=15)
        assert history_j[-1] <= 1e-7, history_j
        full_j = JH.to_f64(sj)
        assert abs(float(rj.gradient64(rj.fmp64, full_j)[3]) - om_ref) \
            / om_ref < 1e-6
        _assert_distances(np.asarray(full_j.points), np_(st.points))

    r = refine.Refiner(prob32, spec, use_kernels=use_kernels)
    assert (r.fmp32.vm_pb is not None) == use_kernels
    s, history = r.refine(s32, tolerance=1e-7, max_iterations=15)
    assert history[-1] <= 1e-7, history
    full = hilo.to_f64(s)
    omega0 = float(r.gradient64(r.fmp64, full)[3])
    assert abs(omega0 - om_ref) / om_ref < 1e-6
    _assert_distances(np_(full.points), np_(st.points))


def test_refiner_layout_fits_k2_at_g16_v4():
    """The Refiner lays its f32 problem out through `choose_pb` with its
    own G: at V = 4, G = 16 (1,536 points after the engine's padding) the
    largest block whose K2 tile fits (96), not the largest the thread
    limit allows (128, whose tile K2 refuses)."""
    from test_torch_cuda import _g16_v4_problem

    prob, _, spec = _g16_v4_problem(CPU)
    r = refine.Refiner(prob, spec, use_kernels=True)
    assert r.fmp32.num_points % 128 == 0
    assert r.fmp32.vm_pb == 96 and kernels.k2_tile_fits(96, 4, 16)
    assert not kernels.k2_tile_fits(128, 4, 16)
