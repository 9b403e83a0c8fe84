"""The reference API on the scale engine (`parallel/solver.ScaleBundleAdjustment`
and `rcs.rcs_from_problem`), float64 on the CPU: the cases of
tests/test_scale_driver.py for both of the port's classes (the estimate
matches the dense one at that file's tolerances, SIMULATION, interrupt and
events, the shared gain schedule; the result writers are not ported), the
port's ScaleBundleAdjustment against the JAX one, and the padded
point-major layout of `rcs_from_problem` against the JAX RCSProblem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_scene import (direct_group_scene, port_coords, port_scene,
                              rig_scene, two_camera_scene, zernike_scene)
from bundle_adjustment_tpu import MatrixInversion as JMI
from bundle_adjustment_tpu.models.problem import ParamState as JParamState
from bundle_adjustment_tpu.models.problem import compile_problem as j_compile
from bundle_adjustment_tpu.parallel import rcs as JR
from bundle_adjustment_tpu.parallel import solver as JS
from bundle_adjustment_tpu.testing import make_synthetic_scene as j_scene
from bundle_adjustment_tpu_torch.models.problem import ParamState
from bundle_adjustment_tpu_torch.models.problem import compile_problem
from bundle_adjustment_tpu_torch.parallel import engine, rcs, solver
from bundle_adjustment_tpu_torch.solver.adjustment import (
    BundleAdjustment, EstimationState, EstimationType, MatrixInversion)
from bundle_adjustment_tpu_torch.testing import make_synthetic_scene
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


def _scene(seed=21):
    return make_synthetic_scene(
        num_points=25, num_images=6, noise=1e-4, sigma=1e-4, perturb=0.01,
        seed=seed, with_scale_bar=True)


def _adjust(cls, cameras, bars, **kw):
    adj = cls(device=CPU)
    adj.add(*cameras, *bars)
    for k, v in kw.items():
        setattr(adj, k, v)
    return adj


BOTH = [BundleAdjustment, solver.ScaleBundleAdjustment]


@pytest.fixture(scope="module")
def dense_estimate_ref():
    cameras, bars, _ = _scene()
    adj = _adjust(BundleAdjustment, cameras, bars)
    adj.set_invert_normal_equation(MatrixInversion.REDUCED)
    assert adj.estimate_model() == EstimationState.ERROR_FREE_ESTIMATION
    return (adj.state.points.numpy().copy(), adj.omega,
            adj.get_variance_factor_aposteriori(), adj.Qxx.numpy().copy())


@pytest.mark.parametrize("cls", BOTH, ids=["dense", "scale"])
def test_estimate_matches_dense(cls, dense_estimate_ref):
    cameras, bars, _ = _scene()
    adj = _adjust(cls, cameras, bars)
    adj.set_invert_normal_equation(MatrixInversion.REDUCED)
    assert adj.estimate_model() == EstimationState.ERROR_FREE_ESTIMATION
    pts_d, om_d, s2_d, Q_d = dense_estimate_ref
    np.testing.assert_allclose(adj.state.points.numpy(), pts_d, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(adj.omega, om_d, rtol=1e-8)
    np.testing.assert_allclose(adj.get_variance_factor_aposteriori(), s2_d,
                               rtol=1e-8)
    np.testing.assert_allclose(adj.Qxx.numpy(), Q_d, rtol=1e-4,
                               atol=1e-6 * np.abs(Q_d).max())


@pytest.mark.parametrize("cls", BOTH, ids=["dense", "scale"])
def test_simulation_mode(cls):
    cameras, bars, truth = _scene(seed=22)
    adj = _adjust(cls, cameras, bars)
    adj.set_estimation_type(EstimationType.SIMULATION)
    adj.set_invert_normal_equation(MatrixInversion.REDUCED)
    adj.use_centroided_coordinates = False
    before = {id(oc): (oc.x.value, oc.y.value, oc.z.value)
              for oc in truth["coords"]}
    assert adj.estimate_model() == EstimationState.ERROR_FREE_ESTIMATION
    assert adj.omega == 0.0
    assert adj.get_variance_factor_aposteriori() == \
        adj.get_variance_factor_apriori()
    for oc in truth["coords"]:
        assert before[id(oc)] == (oc.x.value, oc.y.value, oc.z.value)
    assert adj.Qxx is not None and bool(torch.isfinite(adj.Qxx).all())


@pytest.mark.parametrize("cls", BOTH, ids=["dense", "scale"])
def test_interrupt_and_events(cls):
    cameras, bars, _ = _scene(seed=23)
    adj = _adjust(cls, cameras, bars)
    adj.set_invert_normal_equation(MatrixInversion.NONE)
    events = []

    def listener(name, old, new):
        events.append(name)
        if name == "ITERATE" and new >= 2:
            adj.interrupt()

    adj.add_property_change_listener(listener)
    assert adj.estimate_model() == EstimationState.INTERRUPT
    assert "ITERATE" in events and events[-1] == "INTERRUPT"


def test_lm_damping_cap_shared_schedule():
    from bundle_adjustment_tpu_torch.constants import SQRT_EPS
    from bundle_adjustment_tpu_torch.solver import adjustment

    # the scale driver uses the dense driver's schedule and status taxonomy
    assert solver.lm_gain_update is adjustment.lm_gain_update
    assert solver.EstimationState is adjustment.EstimationState
    assert solver.SQRT_EPS == SQRT_EPS

    lam, omega = 1e5, 0.0
    history = []
    for k in range(60):
        lam, omega, accepted = adjustment.lm_gain_update(lam, omega,
                                                         1e3 * (k + 1))
        history.append((lam, omega, accepted))
        assert lam <= 1.0 / SQRT_EPS + 1e-6
    lams = [h[0] for h in history]
    assert max(lams) == 1.0 / SQRT_EPS
    i_cap = lams.index(1.0 / SQRT_EPS)
    assert history[0][2] and not history[1][2]
    assert history[i_cap][1] == 0.0 and not history[i_cap][2]
    assert history[i_cap + 1][2]
    assert history[i_cap + 1][0] == pytest.approx(0.2 / SQRT_EPS)


def _rig_estimates(scene):
    """(status, iterations, coordinates, Omega, principal distances) of
    the JAX scale class, the port's scale class and the port's dense
    `BundleAdjustment` on one scene (MatrixInversion.NONE)."""
    out = {}
    for side in ("jax", "scale", "dense"):
        cams, _, _, truth = scene()
        if side == "jax":
            adj = JS.ScaleBundleAdjustment()
            coords = truth["coords"]
        else:
            ts = port_scene((cams, [], [], truth))
            cams = ts.cameras
            cls = (solver.ScaleBundleAdjustment if side == "scale"
                   else BundleAdjustment)
            adj = cls(device=CPU)
            coords = port_coords(ts, truth)
        adj.add(*cams)
        adj.set_invert_normal_equation(
            JMI.NONE if side == "jax" else MatrixInversion.NONE)
        out[side] = (int(adj.estimate_model()), adj.iteration_step,
                     np.array([[o.x.value, o.y.value, o.z.value]
                               for o in coords]), adj.omega,
                     np.array([c.io.c.value for c in cams]))
    return out


def _assert_rig_estimates_agree(out, cameras, separation):
    sj, ij, pj, oj, cj = out["jax"]
    assert sj == int(EstimationState.ERROR_FREE_ESTIMATION)
    assert len(cj) == cameras
    # the cameras keep their own IO
    assert np.diff(np.sort(cj)).min() > separation
    for side in ("scale", "dense"):
        st, it, pt, ot, ct = out[side]
        assert st == sj and it == ij, side
        assert np.abs(pt - pj).max() <= 1e-9 * np.abs(pj).max(), side
        np.testing.assert_allclose(ot, oj, rtol=1e-9, err_msg=side)
        np.testing.assert_allclose(ct, cj, rtol=1e-9, err_msg=side)


def test_two_cameras_refused_by_the_scale_class():
    """Two cameras (the free network of tests/test_multi_camera.py, inner
    constraints) are no longer refused: the scale class runs the engine's
    compact rows and matches the JAX scale class and the port's dense
    `BundleAdjustment` (status, iterations, coordinates within 1e-9 of
    the field, Omega rtol 1e-9, as `test_scale_class_matches_jax_scale_class`)."""
    _assert_rig_estimates_agree(_rig_estimates(two_camera_scene), 2, 10.0)


def test_scale_class_on_a_16_camera_rig():
    """16 cameras of four images each (`rig_scene`, 64 images, G = 64):
    the scale class against the JAX scale class and the port's dense
    `BundleAdjustment`, at the tolerances of the two-camera case."""
    _assert_rig_estimates_agree(_rig_estimates(lambda: rig_scene(16)), 16,
                                1.0)


def test_scale_class_matches_jax_scale_class():
    out = {}
    for side in ("jax", "port"):
        cams, bars, truth = j_scene(num_points=25, num_images=6, noise=1e-4,
                                    sigma=1e-4, perturb=0.01, seed=21)
        if side == "jax":
            adj = JS.ScaleBundleAdjustment()
            coords = truth["coords"]
        else:
            ts = port_scene((cams, bars, [], truth))
            cams, bars = ts.cameras, ts.scale_bars
            adj = solver.ScaleBundleAdjustment(device=CPU)
            coords = port_coords(ts, truth)
        adj.add(*cams, *bars)
        adj.set_invert_normal_equation(
            MatrixInversion.NONE if side == "port" else JMI.NONE)
        out[side] = (int(adj.estimate_model()), adj.iteration_step,
                     np.array([[o.x.value, o.y.value, o.z.value]
                               for o in coords]), adj.omega)
    (sj, ij, pj, oj), (st, it, pt, ot) = out["jax"], out["port"]
    assert st == sj == int(EstimationState.ERROR_FREE_ESTIMATION)
    assert it == ij
    assert np.abs(pt - pj).max() <= 1e-9 * np.abs(pj).max()
    np.testing.assert_allclose(ot, oj, rtol=1e-9)


# ---- rcs_from_problem ------------------------------------------------------

@pytest.fixture(scope="module", params=["zernike", "direct_groups"])
def rcs_pair(request):
    make = {"zernike": lambda: zernike_scene(cut=5.0),  # 4-8 views a point
            "direct_groups": direct_group_scene}
    js = make[request.param]()
    ts = port_scene(js)
    bj = j_compile(*js[:3]).problem
    ct = compile_problem(ts.cameras, ts.scale_bars, ts.direct_groups)
    rj = JR.rcs_from_problem(bj, build_tables=False)
    rt = rcs.rcs_from_problem(ct.problem, CPU)
    state_j = JParamState(*(jnp.asarray(a) for a in ct.state))
    state_t = ParamState(*(torch.as_tensor(a) for a in ct.state))
    return request.param, rj, rt, state_j, state_t, ct.problem


def test_rcs_from_problem_fields_match_jax(rcs_pair):
    name, rj, rt, _, _, bp = rcs_pair
    for f in ("free_point", "free_eo", "free_global", "r0", "sb_a", "sb_b",
              "sb_length", "sb_weight", "datum_mask_d", "dp_w", "dp_val",
              "de_w", "de_val", "dg_w", "dg_val", "dpg_idx", "dpg_axis",
              "dpg_val", "dpg_cov"):
        a, b = getattr(rj, f), getattr(rt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-15,
                                       err_msg=f)
    assert rt.defect_flags_d == rj.defect_flags_d
    assert rt.has_extras == rj.has_extras
    # point-major, uniform V, each point's own observations first
    V = rt.point_uniform
    counts = np.bincount(bp.obs_point, minlength=bp.num_points)
    assert V == counts.max() and rt.obs_xy.shape[0] == bp.num_points * V
    live = rt.obs_weight[:, 0, 0].reshape(bp.num_points, V) > 0
    np.testing.assert_array_equal(live.sum(1).numpy(), counts)
    if name == "zernike":
        assert counts.min() < V  # the image format cuts some views
    else:
        assert rt.dpg_idx is not None and rt.de_w is not None


def test_rcs_from_problem_linearises_like_jax(rcs_pair):
    """The padded layout gives the JAX block layout's sums: Omega, the
    point rhs and the global rhs at the start state."""
    _, rj, rt, state_j, state_t, bp = rcs_pair
    bj = jax.jit(lambda st: JR.linearize(rj, st, bp.spec,
                                         jnp.asarray(1e-3)))(state_j)
    fmp = engine.fm_problem(rt)
    bt = engine.linearize(fmp, state_t, bp.spec, 1e-3)
    np.testing.assert_allclose(float(bt.omega0), float(bj.omega0),
                               rtol=1e-10)
    np.testing.assert_allclose(torch.stack(bt.bp, 1).numpy(),
                               np.asarray(bj.bp), rtol=1e-9,
                               atol=1e-12 * np.abs(np.asarray(bj.bp)).max())
    np.testing.assert_allclose(bt.bg.numpy(), np.asarray(bj.bg), rtol=1e-9,
                               atol=1e-12 * np.abs(np.asarray(bj.bg)).max())
