"""The port's scenario-batched step (`parallel/scenario.py`) against the JAX
`scenario.scenario_lm_step` and against the port's own `rcs.lm_step`
run on each network in turn, float64 on the CPU.

* The two scenes of tests/test_aux.py (15 points, 4 images, seeds 51 and
  52, the first three points fixed; Gauss-Newton, cg_tol 1e-12) brought
  across by `convert.scenario_batch_from` in JAX's file order, unpadded:
  states within 1e-9 of the JAX step's (of the field: rtol 1e-9 on the
  coordinates), omega0 rtol 1e-9, and eight steps converge (max|dx| <
  1e-8) as in that test.
* A fleet of uneven visibility: the 60-point, 10-image scene of
  tests/test_torch_rcs_engine.py thinned by its `drop_views` (3 to 10
  views per point), three scenarios that share its index structure (its
  own observations and start, and two with seeded image noise and
  starts; damping 1e-4, cg_tol 1e-12): the same gates against JAX.
* On both, the CG counts equal JAX's at cg_tol 1e-3 (`COUNT_CG_TOL`).
  Tighter, these small self-calibrating systems (33 and 69 unknowns,
  preconditioned condition ~3e6) run CG to counts that follow the
  rounding: at 1e-12 the port reads 70 / 68 and 67 / 64 / 58 against
  JAX's 69 / 68 and 64 / 62 / 59, JAX's own unbatched step reads 63 for
  its batched 64, and the port's two image-sum orders (blocked, sorted)
  read 70 and 69 (PyTorch 2.13 on the CPU).
* `synthetic.scenario_batch(3, 300, 12, 6)` and its file-order cut
  `synthetic.thin_scenarios` (damping 1e-4, cg_tol 1e-14, one CPU
  thread): per scenario the CG count equal to its own `rcs.lm_step`'s,
  the states and omega0 within 1e-12 relative and max_dx within 1e-10
  (the batched sums are the bits of the unbatched ones: the per-point
  sums carry a batching rule, `rcs._SortedSum`, and every other reduction
  and product of the step runs per scenario under vmap, `rcs._PerItem`);
  the counts differ across the batch, so scenarios that stop first are
  frozen while the others go on.  No `torch.func.vmap` fallback warning
  fires.
* A scenario whose observations are its own predictions (zero rhs) stops
  at iteration 0 inside a running batch and keeps its state bit for bit.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch import convert, synthetic
from bundle_adjustment_tpu_torch.models.problem import ParamState
from bundle_adjustment_tpu_torch.parallel import rcs, scenario
from test_torch_rcs_engine import SCENE, drop_views, fixed_datum
from _torch_threads import one_torch_thread  # noqa: F401

FLEET = (3, 300, 12, 6)
# the file-order fleet: 12 views cut to 4, every 10th point keeps 12
THIN_FLEET = (3, 300, 12, 12)
THIN = dict(views=4, every=10)
DAMPING, CG_TOL, CG_MAXITER = 1e-4, 1e-14, 600
UNEVEN_S = 3
UNEVEN_DAMPING = 1e-4
STATE_CG_TOL = 1e-12   # the JAX test's, for the states
COUNT_CG_TOL = 1e-3    # the counts against JAX (module docstring)


def _jax_step(rp, spec, xys, weights, states, damping):
    """The JAX batch of one index structure and one JAX step of it."""
    from bundle_adjustment_tpu.models.problem import ParamState as JState
    from bundle_adjustment_tpu.parallel import scenario as J

    batch = J.make_batch(rp, np.stack(xys), np.stack(weights), JState(
        *(jnp.stack([np.asarray(getattr(s, f)) for s in states])
          for f in JState._fields)))
    new, mdx, om, _ = J.scenario_lm_step(batch, spec, damping,
                                         cg_tol=STATE_CG_TOL, cg_maxiter=300)
    it = J.scenario_lm_step(batch, spec, damping, cg_tol=COUNT_CG_TOL,
                            cg_maxiter=300)[3]
    return dict(batch=batch, spec=spec, damping=damping,
                new=ParamState(*(np.asarray(a) for a in new)),
                max_dx=np.asarray(mdx), omega0=np.asarray(om),
                it=np.asarray(it))


@pytest.fixture(scope="module")
def jax_fleets():
    """The JAX steps of the aux scenes of tests/test_aux.py and of the
    uneven fleet, both in JAX's file order."""
    from bundle_adjustment_tpu.models.layout import assign_columns
    from bundle_adjustment_tpu.models.problem import ParamState as JState
    from bundle_adjustment_tpu.models.problem import compile_problem
    from bundle_adjustment_tpu.parallel import rcs as R
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
    aux = _jax_step(rp, spec, xys, weights, states, 0.0)

    cameras, _, truth = make_synthetic_scene(**SCENE)
    drop_views(cameras, truth["coords"])
    fixed_datum(truth["coords"])
    cs = compile_problem(cameras, [], [])
    rp = R.rcs_from_problem(cs.problem)
    free = np.asarray(rp.free_point)
    xy0 = np.asarray(rp.obs_xy)
    st0 = [np.asarray(a, np.float64) for a in cs.state]
    xys, states = [], []
    for s in range(UNEVEN_S):
        rng = np.random.default_rng([7, s])
        noise = 0.0 if s == 0 else 1.0
        xys.append(xy0 + noise * rng.normal(0, 1e-4, xy0.shape))
        points = st0[0] + noise * rng.normal(0, 0.01, st0[0].shape) * free
        states.append(JState(jnp.asarray(points), *(jnp.asarray(a)
                                                     for a in st0[1:])))
    uneven = _jax_step(rp, cs.problem.spec, xys,
                       [np.asarray(rp.obs_weight)] * UNEVEN_S, states,
                       UNEVEN_DAMPING)
    return dict(aux=aux, uneven=uneven)


def _against_jax(ref):
    batch = convert.scenario_batch_from(ref["batch"], "cpu")
    assert batch.problem.point_uniform is None
    assert batch.obs_xy.shape[1] == ref["batch"].obs_xy.shape[1]  # unpadded
    new, mdx, om, _ = scenario.scenario_lm_step(
        batch, ref["spec"], ref["damping"], cg_tol=STATE_CG_TOL,
        cg_maxiter=300)
    for name in ("points", "eo", "io", "dist"):
        np.testing.assert_allclose(getattr(new, name).numpy(),
                                   getattr(ref["new"], name), rtol=1e-9,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(om.numpy(), ref["omega0"], rtol=1e-9)
    np.testing.assert_allclose(mdx.numpy(), ref["max_dx"], rtol=1e-6)
    it = scenario.scenario_lm_step(batch, ref["spec"], ref["damping"],
                                   cg_tol=COUNT_CG_TOL, cg_maxiter=300)[3]
    assert it.tolist() == ref["it"].tolist()
    return batch, new, mdx


def test_scenario_step_matches_jax(jax_fleets):
    ref = jax_fleets["aux"]
    batch, new, mdx = _against_jax(ref)
    for _ in range(7):
        batch = batch._replace(states=new)
        new, mdx, om, it = scenario.scenario_lm_step(
            batch, ref["spec"], 0.0, cg_tol=1e-12, cg_maxiter=300)
    assert bool((mdx < 1e-8).all())


def test_uneven_scenario_step_matches_jax(jax_fleets):
    ref = jax_fleets["uneven"]
    counts = np.bincount(np.asarray(ref["batch"].problem.obs_point))
    assert counts.min() < counts.max()
    _against_jax(ref)


def _fleet(thin):
    prob_h, xy, w, states, spec = synthetic.scenario_batch(
        *(THIN_FLEET if thin else FLEET), seed=2)
    if thin:
        prob_h, xy, w, states = synthetic.thin_scenarios(prob_h, xy, w,
                                                         states, **THIN)
    prob = convert.problem_to_torch(prob_h, "cpu", torch.float64)
    return prob, xy, w, states, spec


@pytest.fixture(scope="module")
def fleet():
    return _fleet(False)


def _single(prob, xy, w, st, spec):
    p = prob._replace(obs_xy=torch.as_tensor(xy),
                      obs_weight=torch.as_tensor(w))
    st = ParamState(*(torch.as_tensor(a) for a in st))
    dxp, dxc, dxg, b, it = rcs.lm_step(p, st, spec, DAMPING, cg_tol=CG_TOL,
                                       cg_maxiter=CG_MAXITER)
    new, mdx = rcs.apply_step(st, dxp, dxc, dxg)
    return new, float(mdx), float(b.omega0), it


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _own_steps(prob, xy, w, states, spec):
    """Each scenario's step against `rcs.lm_step` on its own network; no
    vmap fallback warning fires."""
    batch = scenario.make_batch(prob, xy, w, states)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        new, mdx, om, it = scenario.scenario_lm_step(
            batch, spec, DAMPING, cg_tol=CG_TOL, cg_maxiter=CG_MAXITER)
    assert not [c for c in caught if "batching rule" in str(c.message)]
    S = xy.shape[0]
    assert new.points.shape == (S,) + tuple(states.points.shape[1:])
    for s in range(S):
        ref, mdx1, om1, it1 = _single(prob, xy[s], w[s],
                                      [a[s] for a in states], spec)
        assert int(it[s]) == it1
        for name in ("points", "eo", "io", "dist"):
            assert _rel(getattr(new, name)[s], getattr(ref, name)) <= 1e-12
        assert abs(float(mdx[s]) / mdx1 - 1) <= 1e-10
        assert abs(float(om[s]) / om1 - 1) <= 1e-12
    assert len(set(it.tolist())) > 1  # the first to stop were frozen


def test_each_scenario_is_its_own_engine_step(fleet):
    """Each scenario's step is the block-layout engine's `rcs.lm_step` on
    its own network (uniform point-major fleet)."""
    assert fleet[0].point_uniform == FLEET[3]
    _own_steps(*fleet)


def test_file_order_fleet_runs_unpadded():
    """The same on the file-order fleet of `synthetic.thin_scenarios`:
    N rows, no padding, the layout rule's choice."""
    prob, xy, w, states, spec = _fleet(True)
    assert prob.point_uniform is None
    assert rcs.choose_layout(prob.obs_point.numpy(), prob.num_points) \
        == "file"
    assert xy.shape[1] == prob.obs_point.shape[0] < \
        prob.num_points * THIN_FLEET[3]
    _own_steps(prob, xy, w, states, spec)


@pytest.mark.parametrize("batched", [True, False],
                         ids=["leading_axis", "trailing_axis"])
def test_per_point_sums_take_no_vmap_fallback(batched):
    """`rcs._sorted_sum` under `torch.func.vmap` warns of no missing
    batching rule and gives the bits of the per-scenario sums."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(4, 50, 3, 2)))
    ids = rng.integers(0, 7, 50)
    order, counts = (torch.as_tensor(a) for a in rcs.point_order(ids, 7))
    one = torch.stack([rcs._sorted_sum(a, order, counts) for a in x])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        if batched:
            out = torch.func.vmap(
                lambda a: rcs._sorted_sum(a, order, counts))(x)
        else:  # the batch axis inside: vmap over the columns
            out = torch.func.vmap(
                lambda a: rcs._sorted_sum(a, order, counts), in_dims=3,
                out_dims=3)(x.movedim(0, 3)).movedim(3, 0)
    assert torch.equal(out, one)
    assert counts.min() >= 0 and int(counts.sum()) == 50


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
