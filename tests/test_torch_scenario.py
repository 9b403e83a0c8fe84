"""The port's scenario-batched step (`parallel/scenario.py`) against the JAX
`scenario.scenario_lm_step` and against the port's own `engine.lm_step`
run on each network in turn, float64 on the CPU.

* The two scenes of tests/test_aux.py (15 points, 4 images, seeds 51 and
  52, the first three points fixed; Gauss-Newton, cg_tol 1e-12) brought
  across by `convert.scenario_batch_from`: states within 1e-9 of the JAX
  step's (of the field: rtol 1e-9 on the coordinates), omega0 rtol 1e-9,
  and eight steps converge (max|dx| < 1e-8) as in that test.
* `synthetic.scenario_batch(3, 300, 12, 6)` (damping 1e-4, cg_tol 1e-14,
  one CPU thread): per scenario the states and omega0 within 1e-12
  relative of its own `engine.lm_step`, max_dx within 1e-10 and the CG
  count within 3 of that step's: the batched reductions and the
  preconditioner's small contractions sum in another order than the
  unbatched ones, and a CG run near its floor turns those last bits into
  a few iterations and ~1e-12 of the step; the counts differ across the
  batch, so scenarios that stop first are frozen while the others go
  on.
* A scenario whose observations are its own predictions (zero rhs) stops
  at iteration 0 inside a running batch and keeps its state bit for bit.
"""

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch import convert, synthetic
from bundle_adjustment_tpu_torch.models.problem import ParamState
from bundle_adjustment_tpu_torch.parallel import engine, rcs, scenario

FLEET = (3, 300, 12, 6)
DAMPING, CG_TOL, CG_MAXITER = 1e-4, 1e-14, 600


@pytest.fixture(scope="module")
def aux_scenes():
    """The JAX batch of tests/test_aux.py and one JAX step of it."""
    import jax.numpy as jnp

    from bundle_adjustment_tpu.models.layout import assign_columns
    from bundle_adjustment_tpu.models.problem import ParamState as JState
    from bundle_adjustment_tpu.models.problem import compile_problem
    from bundle_adjustment_tpu.parallel import rcs as R
    from bundle_adjustment_tpu.parallel import scenario as J
    from bundle_adjustment_tpu.testing import make_synthetic_scene

    states, xys, weights = [], [], []
    rp = spec = None
    for seed in (51, 52):
        cameras, _, truth = make_synthetic_scene(
            num_points=15, num_images=4, noise=1e-4, sigma=1e-4,
            perturb=0.01, seed=seed, with_scale_bar=False)
        for oc in truth["coords"][:3]:
            for par in oc.params:
                par.fixed = True
        cs = compile_problem(cameras, [], [], assign_columns(cameras, [], []))
        r = R.rcs_from_problem(cs.problem)
        if rp is None:
            rp, spec = r, cs.problem.spec
        states.append(JState(*(jnp.asarray(a) for a in cs.state)))
        xys.append(np.asarray(r.obs_xy))
        weights.append(np.asarray(r.obs_weight))
    batch = J.make_batch(rp, np.stack(xys), np.stack(weights), JState(
        *(jnp.stack([np.asarray(getattr(s, f)) for s in states])
          for f in JState._fields)))
    new, mdx, om, it = J.scenario_lm_step(batch, spec, 0.0, cg_tol=1e-12,
                                          cg_maxiter=300)
    host = batch._replace(problem=batch.problem._replace(
        point2obs=None, img2obs=None))
    return dict(batch=host, spec=spec,
                new=ParamState(*(np.asarray(a) for a in new)),
                max_dx=np.asarray(mdx), omega0=np.asarray(om))


def test_scenario_step_matches_jax(aux_scenes):
    batch = convert.scenario_batch_from(aux_scenes["batch"], "cpu")
    new, mdx, om, it = scenario.scenario_lm_step(
        batch, aux_scenes["spec"], 0.0, cg_tol=1e-12, cg_maxiter=300)
    ref = aux_scenes["new"]
    for name in ("points", "eo", "io", "dist"):
        np.testing.assert_allclose(getattr(new, name).numpy(),
                                   getattr(ref, name), rtol=1e-9, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_allclose(om.numpy(), aux_scenes["omega0"], rtol=1e-9)
    np.testing.assert_allclose(mdx.numpy(), aux_scenes["max_dx"], rtol=1e-6)
    for _ in range(7):
        batch = batch._replace(states=new)
        new, mdx, om, it = scenario.scenario_lm_step(
            batch, aux_scenes["spec"], 0.0, cg_tol=1e-12, cg_maxiter=300)
    assert bool((mdx < 1e-8).all())


@pytest.fixture(scope="module")
def fleet():
    prob_h, xy, w, states, spec = synthetic.scenario_batch(*FLEET, seed=2)
    prob = convert.problem_to_torch(prob_h, "cpu", torch.float64)
    return prob, xy, w, states, spec


def _single(prob, xy, w, st, spec):
    p = engine.fm_problem(prob._replace(obs_xy=torch.as_tensor(xy),
                                        obs_weight=torch.as_tensor(w)))
    st = ParamState(*(torch.as_tensor(a) for a in st))
    dxp, dxc, dxg, b, it = engine.lm_step(p, st, spec, DAMPING, cg_tol=CG_TOL,
                                          cg_maxiter=CG_MAXITER)
    new, mdx = rcs.apply_step(st, dxp, dxc, dxg)
    return new, float(mdx), float(b.omega0), it


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_each_scenario_is_its_own_engine_step(fleet, one_thread):
    prob, xy, w, states, spec = fleet
    batch = scenario.make_batch(prob, xy, w, states)
    new, mdx, om, it = scenario.scenario_lm_step(
        batch, spec, DAMPING, cg_tol=CG_TOL, cg_maxiter=CG_MAXITER)
    assert new.points.shape == (FLEET[0],) + tuple(states.points.shape[1:])
    for s in range(FLEET[0]):
        ref, mdx1, om1, it1 = _single(prob, xy[s], w[s],
                                      [a[s] for a in states], spec)
        assert abs(int(it[s]) - it1) <= 3
        for name in ("points", "eo", "io", "dist"):
            assert _rel(getattr(new, name)[s], getattr(ref, name)) <= 1e-12
        assert abs(float(mdx[s]) / mdx1 - 1) <= 1e-10
        assert abs(float(om[s]) / om1 - 1) <= 1e-12
    assert len(set(it.tolist())) > 1  # the first to stop were frozen


def test_a_scenario_that_stops_at_once_stays_frozen(fleet):
    prob, xy, w, states, spec = fleet
    xy = xy.copy()
    st0 = [a[0] for a in states]
    P, V = FLEET[1], FLEET[3]
    xy[0, :P * V] = synthetic.predict(
        st0[0][:P], st0[1], st0[2], st0[3], prob.obs_point[:P * V].numpy(),
        prob.obs_image[:P * V].numpy(), spec)
    batch = scenario.make_batch(prob, xy, w, states)
    new, mdx, om, it = scenario.scenario_lm_step(
        batch, spec, DAMPING, cg_tol=CG_TOL, cg_maxiter=CG_MAXITER)
    assert int(it[0]) == 0 and float(om[0]) == 0.0
    assert int(it[1:].min()) > 0
    for name, a in zip(ParamState._fields, states):
        assert torch.equal(getattr(new, name)[0], torch.as_tensor(a[0]))
    ref, _, _, it1 = _single(prob, xy[1], w[1], [a[1] for a in states], spec)
    assert abs(int(it[1]) - it1) <= 3
    assert _rel(new.points[1], ref.points) <= 1e-12
