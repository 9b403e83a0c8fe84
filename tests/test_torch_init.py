"""The port's initialisation (`init/dlt.py`, `init/transformation.py`) and
tracing (`solver/tracing.py`) against the JAX package, on the CPU.

Every case of tests/test_dlt.py and tests/test_transformation.py runs on
both packages from the same seed-made scenes, and the results agree within
1e-10 (relative to each quantity's scale).  `PhaseTimer` as in
tests/test_aux.py; `device_trace` writes a Chrome trace of a solve step on
the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu import BundleAdjustment as JBA
from bundle_adjustment_tpu import MatrixInversion as JMI
from bundle_adjustment_tpu.init import dlt as JD
from bundle_adjustment_tpu.init import transformation as JT
from bundle_adjustment_tpu.testing import make_synthetic_scene as j_scene
from bundle_adjustment_tpu_torch import BundleAdjustment, MatrixInversion
from bundle_adjustment_tpu_torch.init import dlt as TD
from bundle_adjustment_tpu_torch.init import transformation as TT
from bundle_adjustment_tpu_torch.ops.rotation import rotation_wpk
from bundle_adjustment_tpu_torch.solver.tracing import (TRACE_FILE,
                                                        PhaseTimer,
                                                        device_trace)
from bundle_adjustment_tpu_torch.testing import make_synthetic_scene
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
TOL = 1e-10


def _dlt_scene(make):
    cameras, _, truth = make(num_points=40, num_images=4, noise=0.0,
                             with_distortion=False, with_scale_bar=False,
                             seed=21)
    return cameras[0], {oc.name: oc for oc in truth["coords"]}, truth


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


def _same_result(t, j):
    assert t.converged == j.converged
    _close(t.b, j.b)
    _close([t.x0, t.y0, t.c], [j.x0, j.y0, j.c])
    _close(t.eo, j.eo)


# ---- DLT: the cases of tests/test_dlt.py -----------------------------------

@pytest.mark.parametrize("image", [0, 3])
def test_dlt_recovers_orientation(image):
    cj, coj, truth = _dlt_scene(j_scene)
    ct, cot, _ = _dlt_scene(make_synthetic_scene)
    j = JD.adjust(cj.images[image], coj)
    t = TD.adjust(ct.images[image], cot, device=CPU)
    _same_result(t, j)
    assert t.converged
    assert np.allclose(t.eo[:3], truth["eo"][image, :3], atol=1e-6)
    assert np.isclose(abs(t.c), abs(truth["io"][2]), rtol=1e-6)


def test_dlt_apply_to_respects_fixed_io():
    cj, coj, _ = _dlt_scene(j_scene)
    ct, cot, truth = _dlt_scene(make_synthetic_scene)
    for cam, co, mod, kw in ((cj, coj, JD, {}), (ct, cot, TD, {"device": CPU})):
        cam.io.c.fixed = True
        res = mod.adjust(cam.images[1], co, **kw)
        mod.apply_to(res, cam.images[1])
    assert ct.io.c.value == cj.io.c.value == truth["io"][2]
    _close([p.value for p in ct.images[1].eo.params],
           [p.value for p in cj.images[1].eo.params])
    assert np.allclose(ct.images[1].eo.x0.value, truth["eo"][1, 0], atol=1e-5)


def test_dlt_with_restrictions():
    out = []
    for make, mod, kw in ((j_scene, JD, {}),
                          (make_synthetic_scene, TD, {"device": CPU})):
        cam, co, truth = _dlt_scene(make)
        cam.io.x0.value, cam.io.y0.value = truth["io"][:2]
        out.append(mod.adjust(cam.images[2], co,
                              mod.RestrictionType.FIXED_PRINCIPAL_POINT_X,
                              mod.RestrictionType.FIXED_PRINCIPAL_POINT_Y,
                              **kw))
    j, t = out
    _same_result(t, j)
    assert t.converged
    assert np.isclose(t.x0, truth["io"][0], atol=1e-8)
    assert np.isclose(t.y0, truth["io"][1], atol=1e-8)


def test_validate_restrictions():
    R = TD.RestrictionType
    rs = TD._validate_restrictions([
        R.FIXED_PRINCIPLE_DISTANCE_X, R.IDENTICAL_PRINCIPLE_DISTANCE,
        R.FIXED_PRINCIPLE_DISTANCE_Y, R.FIXED_PRINCIPLE_DISTANCE_X])
    assert rs == [R.FIXED_PRINCIPLE_DISTANCE_X, R.FIXED_PRINCIPLE_DISTANCE_Y]


def test_restriction_rows_match_jax():
    """Each restriction's gradient row (torch.func.grad) and misclosure
    equal the JAX ones (jax.grad) at a generic coefficient vector."""
    import jax.numpy as jnp

    b = np.random.default_rng(0).normal(size=11)
    for r in JD.RestrictionType:
        gj, wj = JD._restriction_row(r, jnp.asarray(b), 0.1, -0.2, -30.0)
        gt, wt = TD._restriction_row(TD.RestrictionType[r.name],
                                     torch.as_tensor(b), 0.1, -0.2, -30.0)
        _close(gt.numpy(), np.asarray(gj))
        _close(wt, wj)


def test_dlt_insufficient_points():
    ct, cot, _ = _dlt_scene(make_synthetic_scene)
    few = dict(list(cot.items())[:4])
    with pytest.raises(ValueError, match="insufficient"):
        TD.adjust(ct.images[3], few, device=CPU)


def test_triangulation():
    out = []
    for make, mod, kw in ((j_scene, JD, {}),
                          (make_synthetic_scene, TD, {"device": CPU})):
        cam, co, _ = _dlt_scene(make)
        results = [mod.adjust(img, co, **kw) for img in cam.images[:3]]
        name = next(ic.object_coordinate.name for ic in cam.images[0]
                    if all(any(jc.object_coordinate.name
                               == ic.object_coordinate.name for jc in img)
                           for img in cam.images[:3]))
        xy = [next((jc.x, jc.y) for jc in img
                   if jc.object_coordinate.name == name)
              for img in cam.images[:3]]
        out.append((mod.triangulate(results, xy, **kw),
                    [co[name].x.value, co[name].y.value, co[name].z.value]))
    (xj, _), (xt, truth) = out
    _close(xt, xj)
    assert np.allclose(xt, truth, atol=1e-6)


def test_entry_points_default_to_cuda():
    ct, cot, _ = _dlt_scene(make_synthetic_scene)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.adjust(ct.images[0], cot)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.triangulate([], [])


# ---- transformation: the cases of tests/test_transformation.py -------------

@pytest.fixture(scope="module")
def solved():
    out = {}
    for side in ("jax", "port"):
        make = j_scene if side == "jax" else make_synthetic_scene
        cameras, bars, truth = make(num_points=20, num_images=5, noise=1e-4,
                                    sigma=1e-4, perturb=0.0, seed=31)
        if side == "jax":
            adj = JBA()
            adj.set_invert_normal_equation(JMI.FULL)
        else:
            adj = BundleAdjustment(device=CPU)
            adj.set_invert_normal_equation(MatrixInversion.FULL)
        adj.add(cameras[0], *bars)
        adj.estimate_model()
        out[side] = (adj, cameras[0], truth)
    return out


def _transform(solved, pick, mod, side, Q=None):
    adj, cam, truth = solved[side]
    ref, images, coords = pick(cam, truth)
    Qxx = adj.Qxx if Q is None else Q(adj.Qxx)
    return mod.transform(coords, {ref: images},
                         adj.get_variance_factor_aposteriori(), Qxx), cam


def _forward(cam, truth):
    return cam.images[0], [cam.images[1]], truth["coords"][:5]


def _identity(cam, truth):
    ref = cam.images[0]
    return ref, [ref], [oc for oc in truth["coords"][:4]
                        if any(ic.object_coordinate is oc for ic in ref)]


def _two_sources(cam, truth):
    return cam.images[2], [cam.images[0], cam.images[3]], truth["coords"][:6]


@pytest.mark.parametrize("pick", [_forward, _identity, _two_sources],
                         ids=["forward", "identity", "two_sources"])
@pytest.mark.parametrize("q", ["tensor", "numpy"])
def test_transform_matches_jax(solved, pick, q):
    rj, _ = _transform(solved, pick, JT, "jax")
    conv = (lambda Q: Q) if q == "tensor" else (lambda Q: Q.numpy())
    rt, cam = _transform(solved, pick, TT, "port", conv)
    assert rt.names == rj.names and len(rt.names) > 0
    _close(rt.points, rj.points)
    # the covariance in its own correlation scale
    s = np.sqrt(np.diagonal(rj.covariance))
    assert np.abs((rt.covariance - rj.covariance) / s[:, None]
                  / s[None, :]).max() <= 1e-8
    if pick is _forward:
        src, ref = cam.images[1], cam.images[0]
        eo_s = torch.tensor([p.value for p in src.eo.params],
                            dtype=torch.float64)
        eo_t = torch.tensor([p.value for p in ref.eo.params],
                            dtype=torch.float64)
        Rs, Rt = rotation_wpk(*eo_s[3:]), rotation_wpk(*eo_t[3:])
        for k, name in enumerate(rt.names):
            oc = next(o for o in solved["port"][2]["coords"]
                      if o.name == name.split()[0])
            X = torch.tensor([oc.x.value, oc.y.value, oc.z.value],
                             dtype=torch.float64)
            expect = eo_t[:3] + Rt @ (Rs.T @ (X - eo_s[:3]))
            assert np.allclose(rt.points[k], expect.numpy(), atol=1e-12)
    if pick is _identity:
        adj, cam, truth = solved["port"]
        coords = _identity(cam, truth)[2]
        cols = np.array([[oc.x.column, oc.y.column, oc.z.column]
                         for oc in coords]).reshape(-1)
        expect = adj.get_variance_factor_aposteriori() * adj.Qxx.numpy()[
            np.ix_(cols, cols)]
        assert np.allclose(rt.covariance, expect, rtol=1e-8, atol=1e-16)


def test_transform_jacobian_matches_jax():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    params = np.concatenate([
        rng.normal(0, 100, 3), rng.normal(0, 1, 3),
        rng.normal(0, 100, 3), rng.normal(0, 1, 3),
        rng.normal(0, 50, 3)])
    Jj = np.asarray(jax.jacfwd(JT._transform_one)(jnp.asarray(params)))
    Jt = torch.func.jacfwd(TT._transform_one)(torch.as_tensor(params))
    _close(Jt.numpy(), Jj)
    eps = 1e-6
    for k in range(15):
        p1, p2 = params.copy(), params.copy()
        h = eps * max(1.0, abs(params[k]))
        p1[k] += h
        p2[k] -= h
        fd = (TT._transform_one(torch.as_tensor(p1))
              - TT._transform_one(torch.as_tensor(p2))).numpy() / (2 * h)
        assert np.allclose(Jt[:, k].numpy(), fd, rtol=1e-4, atol=1e-6)


# ---- tracing -----------------------------------------------------------------

def test_phase_timer():
    t = PhaseTimer()
    t.listener("ITERATE", 100, 1)
    t.listener("CONVERGENCE", 1e-8, 1e-3)
    t.listener("ITERATE", 100, 2)
    report = t.report()
    assert "ITERATE" in report and "CONVERGENCE" in report
    assert t.counts["ITERATE"] == 2


def test_device_trace_writes_a_trace(tmp_path):
    cams, bars, _ = make_synthetic_scene(num_points=12, num_images=4,
                                         noise=1e-4, sigma=1e-4, seed=2)
    adj = BundleAdjustment(device=CPU)
    adj.add(cams[0], *bars)
    timer = PhaseTimer()
    adj.add_property_change_listener(timer.listener)
    logdir = str(tmp_path / "trace")
    with device_trace(logdir):
        adj.estimate_model()
    path = os.path.join(logdir, TRACE_FILE)
    with open(path) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("linalg" in n or "mm" in n for n in names)
    assert "ITERATE" in timer.report()
