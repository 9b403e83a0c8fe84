"""The port's entry points on a network of uneven visibility against the
JAX package, on the CPU in f64: `solver.solve` and `ScaleBundleAdjustment`
(which step through the block-layout engine for a file-order problem, as
the JAX ones do), the covariance blocks on demand (`parallel/covariance.py`
on an `rcs.RCSProblem`) and the file route (`io.columnar.build_rcs_problem`
with ``layout="file"``).

The scene is tests/test_torch_rcs_engine.py's thinned network (3 to 10
views per point, three points held fixed).  Tolerances:
* `solve` (damping 1e-2, cg_tol 1e-12): the same iterations, the same
  event stream and damping sequence as the JAX `solve`; Omega rtol 1e-8
  and the coordinates within 1e-7 of the field
  (tests/test_torch_solver.py's).  Step for step, the same CG count per
  iteration too, at `solve`'s default cg_tol 1e-6, on the scene without
  its distortion terms.  With them
  (self-calibration, G = 3 + K) the reduced system's CG runs to about its
  dimension in the later steps, where a finite-precision CG count follows
  the summation order: the port's own blocked and image-sorted image sums
  stop 7 to 14 iterations apart on those steps, as the JAX run does from
  either; without them every count is equal in all three runs;
* `ScaleBundleAdjustment`: status and iterations equal, sigma0 and Omega
  rtol 1e-9, coordinates within 1e-9 of the field
  (tests/test_torch_scale_driver.py's JAX comparison);
* covariance blocks: rtol 1e-6 at PCG tol 1e-12 against the JAX functions
  (tests/test_torch_covariance.py's: two PCGs with other preconditioners
  stop at 1e-12 relative);
* `build_rcs_problem(layout="file")`: every array equal to the JAX
  function's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_columnar import _network
from test_torch_rcs_engine import CPU, np_, ragged_problems, ragged_scenes
from bundle_adjustment_tpu.io import columnar as JCol
from bundle_adjustment_tpu.parallel import covariance as JC
from bundle_adjustment_tpu.parallel import rcs as JR
from bundle_adjustment_tpu.parallel import solver as JS
from bundle_adjustment_tpu_torch.io import columnar as TCol
from bundle_adjustment_tpu_torch.io import scene_files
from bundle_adjustment_tpu_torch.parallel import covariance, engine, rcs
from bundle_adjustment_tpu_torch.parallel import solver
from _torch_threads import one_torch_thread  # noqa: F401

KW = dict(damping=1e-2, max_iterations=40)
# the self-calibrating scene to a CG tolerance whose steps resolve its
# weakly determined coordinates (tests/test_torch_solver.py takes 1e-13)
KW_TIGHT = dict(KW, cg_tol=1e-12, cg_maxiter=500)
POINTS = np.array([0, 7, 20, 41], np.int32)   # 10, 3..5 views
PAIRS = np.array([[0, 7], [20, 41]])
IMAGES = np.array([1, 6], np.int32)
TOL = dict(tol=1e-12, maxiter=2000)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX solve, scale class and covariance blocks, computed once."""
    bpj, rpj, sj, bpt, st = ragged_problems()
    spec = bpj.spec
    ev = []
    res = JS.solve(rpj, sj, spec, listeners=[lambda *a: ev.append(a)],
                   **KW_TIGHT)
    plain = ragged_problems(with_distortion=False)
    ev0 = []
    res0 = JS.solve(plain[1], plain[2], plain[0].spec,
                    listeners=[lambda *a: ev0.append(a)], **KW)
    # the scale class on the thinned scene objects
    (jc, jco), _ = ragged_scenes()
    adj = JS.ScaleBundleAdjustment()
    adj.add(*jc)
    adj.set_invert_normal_equation(_jmi().NONE)
    scale = (int(adj.estimate_model()), adj.iteration_step, adj.omega,
             adj.get_variance_factor_aposteriori(),
             np.array([[o.x.value, o.y.value, o.z.value] for o in jco]))
    # covariance blocks at the converged state
    state = res.state
    blocks = JR.linearize(rpj, state, spec, 0.0)
    cov = dict(
        points=np.asarray(JC.point_covariance_blocks(rpj, blocks, POINTS,
                                                     **TOL)),
        pairs=np.asarray(JC.point_pair_covariance_blocks(rpj, blocks, PAIRS,
                                                         **TOL)),
        cameras=np.asarray(JC.camera_covariance_blocks(rpj, blocks, IMAGES,
                                                       **TOL)))
    return dict(bpt=bpt, st=st, spec=spec, res=res, events=ev, scale=scale,
                cov=cov, plain=(plain[3], plain[4], res0, ev0))


def _jmi():
    from bundle_adjustment_tpu import MatrixInversion

    return MatrixInversion


@pytest.fixture(scope="module")
def port_solve(jax_side):
    p = rcs.rcs_from_problem(jax_side["bpt"], CPU)
    ev = []
    res = solver.solve(p, jax_side["st"], jax_side["spec"],
                       listeners=[lambda *a: ev.append(a)], **KW_TIGHT)
    return p, res, ev


def _same_run(res, ev, rj, ev_j):
    assert res.converged and rj.converged
    assert res.iterations == rj.iterations
    assert [h["damping"] for h in res.history] == \
        [h["damping"] for h in rj.history]
    assert [e[0] for e in ev] == [e[0] for e in ev_j]
    for a, b in zip(ev, ev_j):
        if a[0] == "LEVENBERG_MARQUARDT_STEP":
            np.testing.assert_allclose(a[1:], b[1:], rtol=1e-12)
    np.testing.assert_allclose(res.omega, rj.omega, rtol=1e-8)
    want = np.asarray(rj.state.points)
    np.testing.assert_allclose(np_(res.state.points), want, rtol=0,
                               atol=1e-7 * np.abs(want).max())


def test_solve_matches_jax(jax_side, port_solve):
    p, res, ev = port_solve
    assert p.point_uniform is None
    _same_run(res, ev, jax_side["res"], jax_side["events"])


def test_solve_matches_jax_step_for_step(jax_side):
    bpt, st, rj, ev_j = jax_side["plain"]
    p = rcs.rcs_from_problem(bpt, CPU)
    assert p.point_uniform is None
    ev = []
    res = solver.solve(p, st, bpt.spec, listeners=[lambda *a: ev.append(a)],
                       **KW)
    _same_run(res, ev, rj, ev_j)
    assert [h["cg_it"] for h in res.history] == \
        [h["cg_it"] for h in rj.history]


def test_solve_takes_the_block_layout_engine(jax_side, monkeypatch):
    """A file-order problem steps through `rcs.lm_step_full` (never the
    feature-major engine, never padded), with K3 on request (its plain
    version on the CPU); naming K1 or K2 raises."""
    p = rcs.rcs_from_problem(jax_side["bpt"], CPU)
    seen = []
    real = rcs.lm_step_full

    def spy(*a, **kw):
        seen.append(kw["cam_gather"] is not None)
        return real(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the feature-major engine ran")

    monkeypatch.setattr(rcs, "lm_step_full", spy)
    monkeypatch.setattr(engine, "lm_step_full", refuse)
    r0 = solver.solve(p, jax_side["st"], jax_side["spec"], max_iterations=2)
    r1 = solver.solve(p, jax_side["st"], jax_side["spec"], max_iterations=2,
                      use_kernels=("K3",))
    assert seen == [False, False, True, True]
    assert r1.history == r0.history
    assert torch.equal(r1.state.points, r0.state.points)
    assert r1.state.points.shape == (p.num_points, 3)
    for names in (("K1",), ("K2", "K3"), ("K1", "K2", "K3")):
        with pytest.raises(ValueError, match="'file' layout"):
            solver.solve(p, jax_side["st"], jax_side["spec"],
                         use_kernels=names)


def test_scale_class_matches_jax(jax_side):
    _, (tc, tco) = ragged_scenes()
    adj = solver.ScaleBundleAdjustment(device=CPU)
    adj.add(*tc)
    adj.set_invert_normal_equation(_tmi().NONE)
    st, it, om, s2, pts = jax_side["scale"]
    assert int(adj.estimate_model()) == st
    assert adj.iteration_step == it
    np.testing.assert_allclose(adj.omega, om, rtol=1e-9)
    np.testing.assert_allclose(adj.get_variance_factor_aposteriori(), s2,
                               rtol=1e-9)
    got = np.array([[o.x.value, o.y.value, o.z.value] for o in tco])
    assert np.abs(got - pts).max() <= 1e-9 * np.abs(pts).max()


def _tmi():
    from bundle_adjustment_tpu_torch.solver.adjustment import MatrixInversion

    return MatrixInversion


def test_scale_class_builds_the_file_layout(jax_side, monkeypatch):
    """`ScaleBundleAdjustment` asks `rcs_from_problem` for the layout rule's
    choice (layout None), which is ``"file"`` on this scene."""
    made = []
    real = rcs.rcs_from_problem

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(rcs, "rcs_from_problem", spy)
    _, (tc, _) = ragged_scenes()
    adj = solver.ScaleBundleAdjustment(device=CPU)
    adj.add(*tc)
    adj.set_invert_normal_equation(_tmi().NONE)
    adj.estimate_model()
    assert made and all(m.point_uniform is None for m in made)


@pytest.fixture(scope="module")
def port_cov(jax_side, port_solve):
    p, res, _ = port_solve
    b, Minv = covariance.prepare(p, res.state, jax_side["spec"])
    return p, b, Minv


@pytest.mark.parametrize("what", ["points", "pairs", "cameras"])
def test_covariance_blocks_match_jax(jax_side, port_cov, what):
    p, b, Minv = port_cov
    assert isinstance(b, rcs.Blocks)
    fn, ids = {"points": (covariance.point_covariance_blocks, POINTS),
               "pairs": (covariance.point_pair_covariance_blocks, PAIRS),
               "cameras": (covariance.camera_covariance_blocks, IMAGES)}[what]
    stats = {}
    got = np_(fn(p, b, Minv, ids, stats=stats, **TOL))
    want = jax_side["cov"][what]
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-12 * np.abs(want).max())
    assert 0 < stats["iterations"] < TOL["maxiter"]


def test_build_rcs_problem_file_layout_equals_jax(tmp_path):
    paths, spec = _network(tmp_path)
    args = (paths["points"], paths["imagecoords"], paths["eor"])
    jp, js, _ = JCol.build_rcs_problem(*args, io_path=paths["ior"],
                                       spec=spec, dtype=jnp.float64)
    tp, ts, _ = TCol.build_rcs_problem(*args, io_path=paths["ior"],
                                       spec=spec, device=CPU,
                                       dtype=torch.float64, layout="file")
    assert tp.point_uniform is None
    for f in ("obs_point", "obs_image", "obs_xy", "obs_weight", "img_perm",
              "img_block_starts", "cam_of_image", "r0", "free_point",
              "free_eo", "free_global"):
        np.testing.assert_array_equal(np_(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for f in ("points", "io", "dist", "eo"):
        np.testing.assert_array_equal(np_(getattr(ts, f)),
                                      np.asarray(getattr(js, f)), err_msg=f)
    order, counts = rcs.point_order(np.asarray(jp.obs_point), jp.num_points)
    np.testing.assert_array_equal(np_(tp.point_order), order)
    np.testing.assert_array_equal(np_(tp.point_counts), counts)
    # this network is near-uniform: the rule keeps the padded layout
    assert TCol.build_rcs_problem(*args, spec=spec, device=CPU,
                                  dtype=torch.float64)[0].point_uniform == 7


def test_build_rcs_problem_picks_file_order_for_uneven_visibility(tmp_path):
    """A file of uneven visibility (every tenth point in all 6 images, the
    rest in 2; rows grouped by image): layout None gives ``"file"`` with
    the rows in file order, and `solve` converges on it."""
    rng = np.random.default_rng(2)
    P, M = 40, 6
    from bundle_adjustment_tpu_torch import synthetic
    from bundle_adjustment_tpu_torch.models.distortion import \
        DistortionSpecBuilder
    from bundle_adjustment_tpu_torch.testing import look_at_wpk

    pts = rng.uniform(-5, 5, (P, 3))
    pts[:, 2] *= 0.2
    eo = np.zeros((M, 6))
    for m in range(M):
        ang = 2 * np.pi * m / M
        pos = np.array([30 * np.cos(ang), 30 * np.sin(ang), 25.0])
        eo[m] = [*pos, *look_at_wpk(pos, np.zeros(3))]
    obs_point = np.repeat(np.arange(P), M)
    obs_image = np.tile(np.arange(M), P)
    keep = (obs_point % 10 == 0) | ((obs_image - obs_point) % M < 2)
    obs_point, obs_image = obs_point[keep], obs_image[keep]
    order = np.argsort(obs_image, kind="stable")
    obs_point, obs_image = obs_point[order], obs_image[order]
    spec = DistortionSpecBuilder().build()
    io = np.array([0.0, 0.0, -30.0])
    xy = synthetic.predict(pts, io[None], np.zeros((1, 0)), eo, obs_point,
                           obs_image, spec) + rng.normal(0, 1e-3, (len(
                               obs_point), 2))
    paths = scene_files.write_flat_files(
        str(tmp_path / "net"), [f"T{i}" for i in range(P)], pts,
        np.arange(P) < 4, obs_point, obs_image, xy, 1e-3, eo, io)
    args = (paths["points"], paths["imagecoords"], paths["eor"])
    tp, ts, _ = TCol.build_rcs_problem(*args, io_path=paths["ior"],
                                       spec=spec, device=CPU,
                                       dtype=torch.float64)
    assert tp.point_uniform is None
    np.testing.assert_array_equal(np_(tp.obs_point), obs_point)
    res = solver.solve(tp, ts, spec, damping=1e-3, max_iterations=40)
    assert res.converged
