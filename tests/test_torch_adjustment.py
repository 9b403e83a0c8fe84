"""The port's dense `BundleAdjustment` (solver/adjustment.py), float64 on the
CPU: the cases of tests/test_solver_synthetic.py, test_multi_camera.py
(two cameras) and test_checkpoint_resume.py on the port, at those tests'
tolerances; and the port against the JAX solver on the same scenes.

Port against JAX: the same status and iteration count, sigma0 within 1e-9
(relative), coordinates within 1e-9 of the field size, and the cofactor
matrix in the Jacobi scale (D Q D, D = sqrt(diag N)) within 1e-8 of its
largest entry for FULL and NONE's solve; within 1e-7 for REDUCED and
PRE_ELIMINATION: those invert the EO-reduced S, whose IO / distortion
block is a difference of near-equal terms, and the JAX package's own
REDUCED / PRE_ELIMINATION results differ from its FULL by 0.7-6e-8 in the
same scale on these scenes, so no second implementation can hold them
tighter.  A singular network (every datum released; an image without
observations) ends in SINGULAR_MATRIX on both sides.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_scene import (direct_group_scene, port_coords, port_scene,
                              two_camera_scene, zernike_scene)
from bundle_adjustment_tpu import BundleAdjustment as JBA
from bundle_adjustment_tpu import MatrixInversion as JMI
from bundle_adjustment_tpu.testing import make_synthetic_scene as j_scene
from bundle_adjustment_tpu_torch import (BundleAdjustment, EstimationState,
                                         EstimationType, MatrixInversion)
from bundle_adjustment_tpu_torch.ops.assembly import make_assembler
from bundle_adjustment_tpu_torch.solver import adjustment as TA
from bundle_adjustment_tpu_torch.testing import make_synthetic_scene

CPU = "cpu"
MODES = ("FULL", "REDUCED", "PRE_ELIMINATION", "NONE")


def _solve(cameras, scale_bars, mode=MatrixInversion.FULL, damping=0.0,
           direct_groups=(), max_iter=100):
    adj = BundleAdjustment(device=CPU)
    for c in cameras:
        adj.add(c)
    for s in scale_bars:
        adj.add(s)
    for g in direct_groups:
        adj.add(g)
    adj.set_invert_normal_equation(mode)
    adj.set_maximal_number_of_iterations(max_iter)
    if damping:
        adj.set_levenberg_marquardt_damping_value(damping)
    status = adj.estimate_model()
    return adj, status


def _xyz(coords):
    return np.array([[oc.x.value, oc.y.value, oc.z.value] for oc in coords])


# ---- the cases of tests/test_solver_synthetic.py on the port ---------------

def test_noise_free_recovery():
    cameras, scale_bars, truth = make_synthetic_scene(
        num_points=30, num_images=6, noise=0.0, perturb=0.05, seed=1)
    adj, status = _solve(cameras, scale_bars)
    assert status == EstimationState.ERROR_FREE_ESTIMATION
    assert adj.omega < 1e-10
    pts_est, pts_true = _xyz(truth["coords"]), truth["points"]
    np.testing.assert_allclose(np.linalg.norm(pts_est[0] - pts_est[10]),
                               np.linalg.norm(pts_true[0] - pts_true[10]),
                               rtol=1e-8)


def test_counts_and_dof():
    cameras, scale_bars, _ = make_synthetic_scene(
        num_points=30, num_images=6, seed=2)
    adj, _ = _solve(cameras, scale_bars)
    p = adj.problem
    assert adj.get_number_of_observations() == 2 * p.num_image_obs + 1
    assert adj.get_number_of_unknown_parameters() == 90 + 3 + 6 + 36
    assert adj.get_number_of_datum_conditions() == 6
    assert adj.get_degree_of_freedom() == (
        adj.get_number_of_observations()
        - adj.get_number_of_unknown_parameters() + 6)


def test_noisy_network_sigma_ratio():
    cameras, scale_bars, _ = make_synthetic_scene(
        num_points=60, num_images=10, noise=5e-4, sigma=5e-4,
        perturb=0.01, seed=3)
    adj, status = _solve(cameras, scale_bars)
    assert status == EstimationState.ERROR_FREE_ESTIMATION
    ratio = adj.get_variance_factor_aposteriori() \
        / adj.get_variance_factor_apriori()
    assert 0.8 < ratio < 1.25


def test_schur_modes_match_full():
    kw = dict(num_points=25, num_images=5, noise=1e-4, sigma=1e-4,
              perturb=0.01, seed=4)
    results = {}
    for mode in (MatrixInversion.FULL, MatrixInversion.REDUCED,
                 MatrixInversion.PRE_ELIMINATION):
        cams, sbs, tr = make_synthetic_scene(**kw)
        adj, status = _solve(cams, sbs, mode=mode)
        assert status == EstimationState.ERROR_FREE_ESTIMATION
        results[mode] = (_xyz(tr["coords"]), adj.Qxx.numpy(),
                         adj.problem.reduced_size, adj.omega)
    full_pts, full_Q, nR, full_om = results[MatrixInversion.FULL]
    for mode in (MatrixInversion.REDUCED, MatrixInversion.PRE_ELIMINATION):
        pts, Q, _, om = results[mode]
        assert np.allclose(pts, full_pts, atol=1e-9)
        assert np.isclose(om, full_om, rtol=1e-6)
        d = 6
        assert np.allclose(Q[d:nR, d:nR], full_Q[d:nR, d:nR],
                           rtol=2e-4, atol=1e-9)


def test_levenberg_marquardt_converges_from_bad_start():
    cameras, scale_bars, _ = make_synthetic_scene(
        num_points=30, num_images=6, noise=1e-4, sigma=1e-4,
        perturb=1.0, seed=5)
    _, status = _solve(cameras, scale_bars, damping=0.1, max_iter=200)
    assert status == EstimationState.ERROR_FREE_ESTIMATION


def test_simulation_mode():
    cameras, scale_bars, truth = make_synthetic_scene(
        num_points=20, num_images=5, seed=6)
    adj = BundleAdjustment(device=CPU)
    adj.add(*cameras, *scale_bars)
    adj.set_estimation_type(EstimationType.SIMULATION)
    adj.set_invert_normal_equation(MatrixInversion.FULL)
    assert adj.estimate_model() == EstimationState.ERROR_FREE_ESTIMATION
    assert adj.omega == 0.0
    assert np.allclose(_xyz(truth["coords"]), truth["points"], atol=1e-12)
    Q = adj.get_cofactor_matrix().numpy()
    p = adj.problem
    assert np.all(np.diag(Q)[p.col_points[p.col_points >= 0]] > 0)


def test_fixed_parameters_stay_fixed():
    cameras, scale_bars, _ = make_synthetic_scene(
        num_points=20, num_images=5, noise=1e-4, sigma=1e-4,
        perturb=0.01, seed=7)
    cam = cameras[0]
    c_before = cam.io.c.value
    cam.io.c.fixed = True
    _, status = _solve(cameras, scale_bars)
    assert status == EstimationState.ERROR_FREE_ESTIMATION
    assert cam.io.c.value == c_before
    assert cam.io.c.column == -2


def test_datum_constraint_nullspace():
    cameras, scale_bars, truth = make_synthetic_scene(
        num_points=30, num_images=6, noise=1e-4, sigma=1e-4,
        perturb=0.0, seed=8)
    before = truth["points"].copy()
    _solve(cameras, scale_bars)
    corr = _xyz(truth["coords"]) - before
    assert np.abs(corr.mean(axis=0)).max() < 1e-6


def test_two_cameras_dense():
    cams, _, _, truth = js = two_camera_scene()
    ts = port_scene(js)
    adj, status = _solve(ts.cameras, [], mode=MatrixInversion.REDUCED)
    assert status == EstimationState.ERROR_FREE_ESTIMATION
    assert abs(ts.cameras[0].io.c.value - ts.cameras[1].io.c.value) > 10
    est = _xyz(port_coords(ts, truth))
    pts = truth["points"]
    np.testing.assert_allclose(np.linalg.norm(est[0] - est[5]),
                               np.linalg.norm(pts[0] - pts[5]), rtol=2e-4)


# ---- the port against the JAX solver ---------------------------------------

def _synthetic(seed=3):
    cams, bars, truth = j_scene(num_points=60, num_images=10, noise=5e-4,
                                sigma=5e-4, perturb=0.01, seed=seed)
    return cams, bars, [], truth


CASES = {f"synthetic-{m}": (_synthetic, m) for m in MODES}
# the reference's reduced_size counts three columns for every point, so
# REDUCED / PRE_ELIMINATION mislay the border on held-fixed coordinates:
# the direct-group scene (three held-fixed components) runs FULL
CASES.update({"direct_groups-FULL": (direct_group_scene, "FULL"),
              "zernike-FULL": (zernike_scene, "FULL"),
              "two_cameras-REDUCED": (two_camera_scene, "REDUCED")})
# centroiding shifts only free coordinates, which contradicts a datum of
# held-fixed ones (the reference's own trait): that scene runs without it
NO_CENTROID = {"direct_groups-FULL"}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    make, mode = CASES[request.param]
    out = {}
    for side in ("jax", "port"):
        cams, bars, groups, truth = js = make()
        adj = JBA() if side == "jax" else BundleAdjustment(device=CPU)
        if side == "port":
            ts = port_scene(js)
            cams, bars, groups = ts.cameras, ts.scale_bars, ts.direct_groups
            coords = port_coords(ts, truth)
        else:
            coords = truth["coords"]
        adj.add(*cams, *bars, *groups)
        adj.use_centroided_coordinates = request.param not in NO_CENTROID
        adj.set_invert_normal_equation(getattr(
            JMI if side == "jax" else MatrixInversion, mode))
        status = adj.estimate_model()
        Q = adj.get_cofactor_matrix()
        out[side] = dict(adj=adj, status=int(status), it=adj.iteration_step,
                         s2=adj.get_variance_factor_aposteriori(),
                         xyz=_xyz(coords),
                         Q=None if Q is None else np.asarray(
                             Q.numpy() if isinstance(Q, torch.Tensor) else Q))
    return request.param, mode, out


def test_status_iterations_and_sigma0_match_jax(pair):
    _, _, o = pair
    j, t = o["jax"], o["port"]
    assert t["status"] == j["status"] == int(EstimationState.ERROR_FREE_ESTIMATION)
    assert t["it"] == j["it"]
    np.testing.assert_allclose(np.sqrt(t["s2"]), np.sqrt(j["s2"]), rtol=1e-9)
    field = np.abs(j["xyz"]).max()
    assert np.abs(t["xyz"] - j["xyz"]).max() <= 1e-9 * field


def test_cofactor_matrix_matches_jax(pair):
    _, mode, o = pair
    j, t = o["jax"], o["port"]
    if mode == "NONE":
        assert t["Q"] is None and j["Q"] is None
        return
    adj = t["adj"]
    _, _, V = make_assembler(adj.problem, CPU)(adj.state, 0.0)
    D = 1.0 / V.numpy()
    ref = D[:, None] * j["Q"] * D[None, :]
    err = np.abs(D[:, None] * t["Q"] * D[None, :] - ref).max()
    tol = 1e-8 if mode == "FULL" else 1e-7
    assert err <= tol * np.abs(ref).max()


# ---- singular networks, OOM, device ----------------------------------------

def _singular(kind):
    cams, bars, truth = j_scene(num_points=20, num_images=5, noise=1e-4,
                                sigma=1e-4, perturb=0.01, seed=12)
    if kind == "no_datum":
        for oc in truth["coords"]:
            oc.set_datum(False)
    else:  # an image that sees nothing: its EO columns are all zero
        cams[0].add_image(99).eo.set(0.0, 0.0, 400.0, 0.0, 0.0, 0.0)
    return cams, bars, [], truth


@pytest.mark.parametrize("mode", ["FULL", "REDUCED"])
@pytest.mark.parametrize("kind", ["no_datum", "empty_image"])
def test_singular_network(kind, mode):
    statuses = []
    for side in ("jax", "port"):
        js = _singular(kind)
        if side == "jax":
            adj = JBA()
            adj.add(*js[0], *js[1])
            adj.set_invert_normal_equation(getattr(JMI, mode))
        else:
            ts = port_scene(js)
            adj = BundleAdjustment(device=CPU)
            adj.add(*ts.cameras, *ts.scale_bars)
            adj.set_invert_normal_equation(getattr(MatrixInversion, mode))
        events = []
        adj.add_property_change_listener(lambda n, o, v: events.append(n))
        statuses.append(int(adj.estimate_model()))
        assert events[-1] == "SINGULAR_MATRIX"
    assert statuses == [int(EstimationState.SINGULAR_MATRIX)] * 2


def test_out_of_memory_maps_to_status(monkeypatch):
    cams, bars, _ = make_synthetic_scene(num_points=20, num_images=5, seed=6)
    adj = BundleAdjustment(device=CPU)
    adj.add(*cams, *bars)

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(torch.linalg, "inv_ex", oom)
    assert adj.estimate_model() == EstimationState.OUT_OF_MEMORY


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert BundleAdjustment().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BundleAdjustment()
    with pytest.raises(RuntimeError, match="cuda"):
        TA.resolve_device("cuda:0")
    assert BundleAdjustment(device="cpu").device.type == "cpu"


# ---- tests/test_checkpoint_resume.py on the port --------------------------

def _build(seed=81):
    cameras, scale_bars, truth = make_synthetic_scene(
        num_points=25, num_images=5, noise=1e-4, sigma=1e-4,
        perturb=0.05, seed=seed)
    adj = BundleAdjustment(device=CPU)
    adj.add(cameras[0])
    for sb in scale_bars:
        adj.add(sb)
    adj.set_invert_normal_equation(MatrixInversion.NONE)
    return adj, truth


def test_checkpoint_resume_matches_straight_run(tmp_path):
    ck = os.path.join(tmp_path, "lm.npz")
    adj1, truth1 = _build()
    assert adj1.estimate_model() == EstimationState.ERROR_FREE_ESTIMATION
    pts1 = _xyz(truth1["coords"])

    adj2, _ = _build()
    adj2.set_checkpointing(ck, every_n_iterations=1)
    adj2.set_maximal_number_of_iterations(3)
    adj2.estimate_model()
    assert os.path.exists(ck)

    adj3, truth3 = _build()
    adj3.resume_from(ck)
    assert adj3.estimate_model() == EstimationState.ERROR_FREE_ESTIMATION
    assert np.allclose(_xyz(truth3["coords"]), pts1, atol=1e-9)
    assert np.isclose(adj3.omega, adj1.omega, rtol=1e-9)
