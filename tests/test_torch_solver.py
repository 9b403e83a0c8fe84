"""The port's LM loop (parallel/solver.py `solve`) against the JAX
`parallel/solver.solve`, on the CPU in f64.

This network is point-major (uniform views): the JAX loop steps through
its block-layout engine, the port through the feature-major engine, so
the two are compared on what does not depend on the path.  (A file-order
network takes the port's block-layout engine, JAX's route: its
step-for-step comparison, CG count per iteration included, is
tests/test_torch_rcs_entry.py.)  Here: both converge from the same start of the same free network (200
points padded to 256, 2 scale bars, six-defect inner-constraint datum,
damping 1e-2) with the same sequence of events; Omega agrees at rtol 1e-8,
the bar lengths and seeded inter-point distances at rtol 1e-8 (datum
invariants; the coordinates themselves too, since both hold B dx = 0 from
the same start, at 1e-7 of the field).  The gain schedule is held against
the JAX `lm_gain_update` on a seeded sequence, value for value.

`solve` tests the coupled preconditioner of the point-major route once
per step (`rcs.definite_coupling`): on this network it is definite at the
start and indefinite from the second step on, where the step takes block
Jacobi, the JAX route's preconditioner.  Where it is definite the step's
bits are those of the untested step (a digest test).
"""

import numpy as np
import pytest
import torch

import hashlib

from test_torch_freenet import network
from test_torch_parity import np_
from bundle_adjustment_tpu.parallel import solver as JS
from bundle_adjustment_tpu.solver import adjustment as JA
from bundle_adjustment_tpu_torch.parallel import engine as TE
from bundle_adjustment_tpu_torch.parallel import rcs, solver
from _torch_threads import one_torch_thread  # noqa: F401

KW = dict(damping=1e-2, max_iterations=40, cg_tol=1e-13, cg_maxiter=3000)


@pytest.fixture(scope="module")
def solved():
    pj, sj, pt, st, spec = network(200, 12, 6, seed=7, bars=2)
    ev_j, ev_t = [], []
    res_j = JS.solve(pj, sj, spec, listeners=[lambda *a: ev_j.append(a)],
                     **KW)
    res_t = solver.solve(pt, st, spec, listeners=[lambda *a: ev_t.append(a)],
                         **KW)
    return pt, st, spec, res_j, res_t, ev_j, ev_t


def test_solve_converges_like_jax(solved):
    pt, _, _, res_j, res_t, _, _ = solved
    assert res_j.converged and res_t.converged
    assert res_t.status == solver.EstimationState.ERROR_FREE_ESTIMATION
    assert int(res_t.status) == int(res_j.status)
    assert res_t.iterations == res_j.iterations == len(res_t.history)
    assert res_t.max_abs_dx <= np.sqrt(np.finfo(np.float64).eps)
    assert res_t.state.points.shape == (256, 3)
    np.testing.assert_allclose(res_t.omega, res_j.omega, rtol=1e-8)
    a, b = np_(res_t.state.points), np.asarray(res_j.state.points)
    ends = (pt.sb_a.long().numpy(), pt.sb_b.long().numpy())
    rng = np.random.default_rng(0)
    pairs = (rng.integers(0, 200, 20), rng.integers(0, 200, 20))
    for i, k in (ends, pairs):
        np.testing.assert_allclose(np.linalg.norm(a[i] - a[k], axis=1),
                                   np.linalg.norm(b[i] - b[k], axis=1),
                                   rtol=1e-8)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-7 * np.abs(b).max())
    np.testing.assert_allclose(np_(res_t.state.eo), np.asarray(res_j.state.eo),
                               rtol=1e-7, atol=1e-9)


def test_solve_fires_the_events_of_jax(solved):
    _, _, _, res_j, res_t, ev_j, ev_t = solved
    assert [e[0] for e in ev_t] == [e[0] for e in ev_j]
    assert ev_t[0] == ("ITERATE", 40, 1)
    assert ev_t[1][0] == "LEVENBERG_MARQUARDT_STEP" and ev_t[1][1] == 1e-2
    assert ev_t[-1][0] == "CONVERGENCE"
    for a, b in zip(ev_t, ev_j):
        if a[0] == "LEVENBERG_MARQUARDT_STEP":
            np.testing.assert_allclose(a[1:], b[1:], rtol=1e-12)
    # the history records each step's damping, CG count and verdict
    h = res_t.history
    assert [x["iter"] for x in h] == list(range(1, len(h) + 1))
    assert all(x["cg_it"] > 0 and x["accepted"] for x in h)
    assert [x["damping"] for x in h] == [x["damping"] for x in res_j.history]


def test_gain_schedule_matches_jax():
    rng = np.random.default_rng(4)
    lam_t = lam_j = 1e-3
    om_t = om_j = 0.0
    seen = set()
    for cur in np.concatenate([rng.uniform(0.5, 2.0, 40),
                               np.linspace(1.0, 60.0, 60)]):
        lam_t, om_t, acc_t = solver.lm_gain_update(lam_t, om_t, float(cur))
        lam_j, om_j, acc_j = JA.lm_gain_update(lam_j, om_j, float(cur))
        assert (lam_t, om_t, acc_t) == (lam_j, om_j, acc_j)
        seen.add(acc_t)
    assert seen == {True, False}
    assert lam_t == 1.0 / solver.SQRT_EPS == 1.0 / JA.SQRT_EPS  # the cap
    assert [int(s) for s in solver.EstimationState] == \
        [int(s) for s in JA.EstimationState]
    assert [s.name for s in solver.EstimationState] == \
        [s.name for s in JA.EstimationState]


def test_simulation_takes_no_step(solved):
    pt, st, spec, _, _, _, _ = solved
    events = []
    res = solver.solve(pt, st, spec, simulation=True,
                       listeners=[lambda *a: events.append(a)], **KW)
    assert res.converged and res.iterations == 0 and res.omega == 0.0
    assert res.max_abs_dx == 0.0
    assert torch.equal(res.state.points, st.points)
    assert [e[0] for e in events] == ["ITERATE", "CONVERGENCE"]
    assert events[0] == ("ITERATE", 40, 1)


def test_interrupted_stops_after_the_polled_iteration(solved):
    pt, st, spec, _, res_t, _, _ = solved
    events, polls = [], []

    def interrupted():
        polls.append(1)
        return len(polls) == 2

    res = solver.solve(pt, st, spec, interrupted=interrupted,
                       listeners=[lambda *a: events.append(a)], **KW)
    assert res.status == solver.EstimationState.INTERRUPT
    assert not res.converged and res.iterations == 2
    assert events[-1] == ("INTERRUPT", False, True)
    assert res.history == res_t.history[:2]


def test_no_convergence_and_the_f32_default_tolerance(solved):
    pt, st, spec, _, _, _, _ = solved
    events = []
    res = solver.solve(pt, st, spec, damping=1e-2, max_iterations=2,
                       cg_tol=1e-13, cg_maxiter=3000,
                       listeners=[lambda *a: events.append(a)])
    assert res.status == solver.EstimationState.NO_CONVERGENCE
    assert events[-1][0] == "NO_CONVERGENCE"
    # f32: the default tolerance is sqrt(eps_f32).  The f32 step floors at
    # max|dx| ~ 1e-3 on this network (the gradient's cancellation, see
    # refine.py), above that default, so the f32 run is given the floor as
    # its tolerance; it goes through the kernels' plain versions
    # (view-major, padded inside `solve`)
    p32 = type(pt)(*(x.float() if isinstance(x, torch.Tensor)
                     and x.dtype == torch.float64 else x for x in pt))
    s32 = type(st)(*(x.float() for x in st))
    tol = []
    solver.solve(p32, s32, spec, max_iterations=1, cg_maxiter=5,
                 listeners=[lambda n, o, v: tol.append(o)
                            if n == "CONVERGENCE" else None])
    assert tol[0] == pytest.approx(3.4526698e-4, rel=1e-6)
    res32 = solver.solve(p32, s32, spec, damping=1e-2, max_iterations=30,
                         tolerance=3e-3, cg_tol=1e-6, cg_maxiter=300,
                         use_kernels=True)
    assert res32.converged and tol[0] < res32.max_abs_dx <= 3e-3
    assert res32.state.points.dtype == torch.float32
    assert res32.state.points.shape == (256, 3)


def test_solve_defaults_to_the_tensors_device(solved, monkeypatch):
    """``use_kernels`` defaults to False for CPU tensors (and to True for
    CUDA tensors): the step sees what `solve` decided."""
    pt, st, spec, _, _, _, _ = solved
    seen = []
    real = TE.lm_step_full

    def spy(*a, **kw):
        seen.append(kw["use_kernels"])
        return real(*a, **kw)

    monkeypatch.setattr(TE, "lm_step_full", spy)
    solver.solve(pt, st, spec, max_iterations=1, cg_maxiter=5)
    assert seen == [False]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(np_(t).tobytes())
    return h.hexdigest()


def test_a_definite_coupling_keeps_the_step_bit_for_bit(solved):
    pt, st, spec, _, res_t, _, _ = solved
    # definite at the start, indefinite later (block Jacobi, JAX's)
    precs = [h["precond"] for h in res_t.history]
    assert precs[0] == "coupled" and "block_jacobi" in precs
    fmp = TE.fm_problem(pt)
    kw = dict(cg_tol=KW["cg_tol"], cg_maxiter=KW["cg_maxiter"])
    chosen = []

    def definite(Minv):
        out = rcs.definite_coupling(Minv)
        chosen.append(out is Minv)
        return out

    plain = TE.lm_step_full(fmp, pt, st, spec, KW["damping"], **kw)
    checked = TE.lm_step_full(fmp, pt, st, spec, KW["damping"],
                              choose_precond=definite, **kw)
    assert chosen == [True]
    assert checked[4] == plain[4]
    assert _digest(checked[:3]) == _digest(plain[:3])


def test_definite_coupling_drops_an_indefinite_coupling():
    rng = np.random.default_rng(3)
    Minv_c = torch.as_tensor(rng.normal(size=(4, 6, 6)))
    Minv_g = torch.eye(3, dtype=torch.float64)
    Scg = torch.as_tensor(rng.normal(size=(4, 6, 3)))
    for diag, coupled in (((1.0, 2.0, 3.0), True), ((1.0, -2.0, 3.0), False)):
        Sh = torch.diag(torch.tensor(diag, dtype=torch.float64))
        M = rcs.Precond(Minv_c=Minv_c, Minv_g=Minv_g, Scg=Scg, W=Scg,
                        Sghat_inv=Sh)
        out = rcs.definite_coupling(M)
        assert (out is M) == coupled
        if not coupled:
            assert out.Scg is None and out.Sghat_inv is None
            assert out.Minv_c is Minv_c and out.Minv_g is Minv_g
