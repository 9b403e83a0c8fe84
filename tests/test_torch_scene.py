"""The port's scene model against the JAX package's, on the CPU.

* `compile_problem`: every array of the port's `BundleProblem` (and the
  state, layout counts and direct groups) is exactly equal to the JAX
  `compile_problem` on five scenes brought across by `convert.scene_from`:
  the synthetic network, the two-camera network of
  tests/test_multi_camera.py, a free network with held-fixed points, a
  populated point group and a diagonal EO / IO group, and a Zernike
  camera.
* `testing.make_synthetic_scene` gives the JAX scene for the same seed:
  the same structure, observations within 1e-12 (one batched projection
  against one call per pair), the same perturbed start.
* Drift guard: the copied pure-Python modules (`constants`,
  `models/parameters`, `models/scene`, `models/layout`) differ from their
  JAX originals only in import lines.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.models import scene as JS
from bundle_adjustment_tpu.models.distortion import DistortionType as DT
from bundle_adjustment_tpu.models.problem import compile_problem as j_compile
from bundle_adjustment_tpu.ops.residuals import predict_image_point
from bundle_adjustment_tpu.testing import look_at_wpk
from bundle_adjustment_tpu.testing import make_synthetic_scene as j_scene
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.models.problem import compile_problem
from bundle_adjustment_tpu_torch.testing import make_synthetic_scene

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# JAX-side scenes (shared with the other test_torch_* files of the dense path)
# ---------------------------------------------------------------------------

def synthetic_scene(seed=2, **kw):
    """(cameras, bars, direct_groups, truth) of the JAX `make_synthetic_scene`."""
    args = dict(num_points=30, num_images=6, noise=1e-4, sigma=1e-4,
                perturb=0.01, seed=seed)
    args.update(kw)
    cams, bars, truth = j_scene(**args)
    return cams, bars, [], truth


def two_camera_scene(seed=0):
    """The two-camera network of tests/test_multi_camera.py."""
    from test_multi_camera import _two_camera_scene

    cams, coords, pts = _two_camera_scene(seed=seed)
    return cams, [], [], {"coords": coords, "points": pts}


def direct_group_scene(seed=5):
    """A free network with three held-fixed coordinates, a populated group
    over three points' coordinates and a diagonal group over one image's
    position and the principal point."""
    cams, bars, _, truth = synthetic_scene(seed=seed)
    coords = truth["coords"]
    coords[7].z.fixed = True
    coords[8].x.fixed = True
    coords[8].y.fixed = True
    rng = np.random.default_rng(seed)
    obs = []
    for oc in coords[:3]:
        for a, t in zip(("x", "y", "z"), ("OBJ_X", "OBJ_Y", "OBJ_Z")):
            p = getattr(oc, a)
            obs.append(JS.DirectObservation(
                parameter=p, value=p.value + rng.normal(0, 1e-3),
                param_type=t, object_coordinate=oc))
    U = rng.normal(0, 1e-4, (9, 9)) + np.eye(9) * 1e-3
    full = JS.DirectlyObservedParameterGroup(obs, dispersion=U.T @ U)
    img = cams[0].images[2]
    diag = [JS.DirectObservation(parameter=p, value=p.value + 0.01,
                                 variance=1e-4, param_type=t)
            for p, t in zip(img.eo.params[:3], ("CAM_X", "CAM_Y", "CAM_Z"))]
    diag.append(JS.DirectObservation(parameter=cams[0].io.x0,
                                     value=cams[0].io.x0.value, variance=1e-6))
    return cams, bars, [full, JS.DirectlyObservedParameterGroup(diag)], truth


def zernike_scene(seed=9, num_points=40, num_images=8, noise=1e-4, cut=40.0):
    """One camera with Zernike-gradient fringes 12 and 24 and a Zernike-X
    fringe 5 beside radial A1; c held fixed (the m = 0 gradients span the
    radial + scale basis, ExampleDistortionModel.java:72-87).  ``cut``:
    the image format, |x|, |y| <= cut."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-50, 50, (num_points, 3))
    pts[:, 2] *= 0.2
    coords = [JS.ObjectCoordinate(str(i + 1), *pts[i])
              for i in range(num_points)]
    cam = JS.Camera(1, r0=8.0, distortion_types=(
        DT.RADIAL_DISTORTION, DT.ZERNIKE_X, DT.ZERNIKE_GRADIENT))
    cam.io.x0.value, cam.io.y0.value, cam.io.c.value = 0.01, -0.02, -30.0
    cam.io.c.fixed = True
    cam.distortion(DT.RADIAL_DISTORTION).add(1, -1e-4)
    cam.distortion(DT.ZERNIKE_X).add(5, 2e-5)
    cam.distortion(DT.ZERNIKE_GRADIENT).add(12, 3e-5)
    cam.distortion(DT.ZERNIKE_GRADIENT).add(24, 2e-5)
    spec = cam.build_spec()
    coeffs = np.zeros(spec.num_coefficients)
    for kind in sorted(cam.distortion_models):
        for key, p in cam.distortion_models[kind].coefficients:
            coeffs[spec.slot_index(kind, key)] = p.value
    io = np.array([0.01, -0.02, -30.0])
    for m in range(num_images):
        ang = 2 * np.pi * m / num_images + 0.3 * (m % 3)
        pos = np.array([220 * np.cos(ang), 220 * np.sin(ang),
                        150.0 + 40.0 * (m % 3)])
        w, p_, k = look_at_wpk(pos, np.zeros(3))
        eo = np.array([*pos, w, p_, k + (m % 4) * np.pi / 2])
        img = cam.add_image(m + 1)
        img.eo.set(*eo)
        for i, oc in enumerate(coords):
            local = np.concatenate([pts[i], io, eo, coeffs])
            xy = np.asarray(predict_image_point(jnp.asarray(local), spec,
                                                cam.r0))
            if np.abs(xy).max() > cut:
                continue
            xy = xy + rng.normal(0, noise, 2)
            img.add(oc, xy[0], xy[1], noise, noise)
    for oc in coords:
        for p in oc.params:
            p.value += rng.normal(0, 0.01)
    bar = JS.ScaleBar(coords[0], coords[1],
                      float(np.linalg.norm(pts[1] - pts[0])), 0.01)
    return [cam], [bar], [], {"coords": coords, "points": pts}


SCENES = {"synthetic": synthetic_scene, "two_cameras": two_camera_scene,
          "direct_groups": direct_group_scene, "zernike": zernike_scene}


def port_scene(jax_scene):
    """The same scene as the port's objects (`convert.scene_from`)."""
    cams, bars, groups, _ = jax_scene
    return convert.scene_from(cams, bars, groups)


def port_coords(scene, truth):
    """The port's object coordinates in the order of ``truth["coords"]``."""
    return [scene.coordinates[oc] for oc in truth["coords"]]


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(SCENES))
def compiled(request):
    js = SCENES[request.param]()
    ts = port_scene(js)
    cj = j_compile(*js[:3])
    ct = compile_problem(ts.cameras, ts.scale_bars, ts.direct_groups)
    return request.param, cj, ct


ARRAYS = ("obs_point", "obs_image", "obs_xy", "obs_var", "obs_rho",
          "cam_of_image", "r0", "col_points", "col_io", "col_dist", "col_eo",
          "sb_a", "sb_b", "sb_length", "sb_var", "datum_mask", "free_points",
          "free_eo_pos")
SCALARS = ("num_points", "num_cameras", "num_images", "num_image_obs",
           "num_scale_bars", "defect_flags", "defect", "num_unknowns",
           "num_observation_rows", "num_io_free", "num_dist_free",
           "sigma2_apriori", "total_size", "reduced_size", "dof")


def test_compile_problem_equals_jax(compiled):
    name, cj, ct = compiled
    pj, pt = cj.problem, ct.problem
    for f in ARRAYS:
        a, b = getattr(pj, f), getattr(pt, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f"{name}: {f}")
    for f in SCALARS:
        assert getattr(pt, f) == getattr(pj, f), (name, f)
    assert [(int(x.kind), x.key, x.order) for x in pt.spec.slots] == \
        [(int(x.kind), x.key, x.order) for x in pj.spec.slots]
    assert [z and z.order for z in pt.spec.zernike] == \
        [z and z.order for z in pj.spec.zernike]
    for a, b in zip(cj.state, ct.state):
        np.testing.assert_array_equal(b, a)
    assert len(pt.direct_groups) == len(pj.direct_groups)
    for gj, gt in zip(pj.direct_groups, pt.direct_groups):
        for f in ("kind", "flat", "col", "values", "weight"):
            np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f))
        assert gt.diagonal == gj.diagonal
    assert [h[:2] for h in ct.handles] == [h[:2] for h in cj.handles]
    assert [oc.name for oc in ct.object_coordinates] == \
        [oc.name for oc in cj.object_coordinates]


def test_scenes_cover_the_cases(compiled):
    name, _, ct = compiled
    p = ct.problem
    if name == "two_cameras":
        assert p.num_cameras == 2 and p.defect == 7
    if name == "direct_groups":
        assert [g.diagonal for g in p.direct_groups] == [False, True]
        assert (p.col_points < 0).sum() == 3 and p.defect < 6
    if name == "zernike":
        assert sum(z is not None for z in p.spec.zernike) == 3
        assert p.col_io[0, 2] == -1
    if name == "synthetic":
        assert p.defect == 6 and p.num_scale_bars == 1


def test_write_back_from_tensors():
    _, _, _, truth = js = synthetic_scene(seed=11)
    ts = port_scene(js)
    ct = compile_problem(ts.cameras, ts.scale_bars, ts.direct_groups)
    st = type(ct.state)(*(torch.as_tensor(a) + 1.0 for a in ct.state))
    ct.write_back(st)
    oc = port_coords(ts, truth)[4]
    assert oc.x.value == ct.state.points[oc.index, 0] + 1.0
    assert ts.cameras[0].io.c.value == ct.state.io[0, 2] + 1.0


def test_scene_from_carries_flags_and_stochastics():
    cams, bars, groups, truth = js = direct_group_scene()
    truth["coords"][3].set_datum(False)
    ts = port_scene(js)
    src, dst = truth["coords"][8], ts.coordinates[truth["coords"][8]]
    assert (dst.x.fixed, dst.y.fixed, dst.z.fixed) == (True, True, False)
    assert not ts.coordinates[truth["coords"][3]].datum
    ic_j = next(iter(cams[0].images[0]))
    ic_t = next(iter(ts.cameras[0].images[0]))
    assert (ic_t.x, ic_t.y, ic_t.var_x, ic_t.var_y, ic_t.rho) == \
        (ic_j.x, ic_j.y, ic_j.var_x, ic_j.var_y, ic_j.rho)
    assert ts.scale_bars[0].variance == bars[0].variance
    np.testing.assert_array_equal(ts.direct_groups[0].dispersion,
                                  groups[0].dispersion)
    assert ts.direct_groups[0].observations[0].parameter is \
        ts.coordinates[truth["coords"][0]].x
    assert [o.param_type for o in ts.direct_groups[1].observations] == \
        [o.param_type for o in groups[1].observations]
    assert src.x.value == dst.x.value


def test_make_synthetic_scene_matches_jax():
    kw = dict(num_points=60, num_images=10, noise=5e-4, sigma=5e-4,
              perturb=0.01, seed=3)
    cj, bj, tj = j_scene(**kw)
    ct, bt, tt = make_synthetic_scene(**kw)
    np.testing.assert_array_equal(tt["points"], tj["points"])
    np.testing.assert_array_equal(tt["eo"], tj["eo"])
    assert tt["dist"] == tj["dist"]
    pj = j_compile(cj, bj, []).problem
    pt = compile_problem(ct, bt, []).problem
    for f in ("obs_point", "obs_image", "obs_var", "col_points", "col_eo",
              "sb_a", "sb_b", "sb_length"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    np.testing.assert_allclose(pt.obs_xy, pj.obs_xy, rtol=0, atol=1e-12)
    for a, b in zip(tt["coords"], tj["coords"]):
        assert (a.x.value, a.y.value, a.z.value) == \
            (b.x.value, b.y.value, b.z.value)
    for a, b in zip(ct[0], cj[0]):
        assert [p.value for p in a.eo.params] == [p.value for p in b.eo.params]


COPIED = ("constants.py", "models/parameters.py", "models/scene.py",
          "models/layout.py")


def _code_lines(path):
    return [line for line in path.read_text().splitlines()
            if not line.startswith(("import ", "from "))]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_modules_do_not_drift(rel):
    ref = _code_lines(ROOT / "bundle_adjustment_tpu" / rel)
    port = _code_lines(ROOT / "bundle_adjustment_tpu_torch" / rel)
    assert port == ref, f"{rel} differs from its JAX original"
