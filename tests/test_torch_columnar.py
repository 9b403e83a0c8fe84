"""The port's columnar loader (`io/columnar.py`) and `solve`'s checkpoints
against the JAX package, on the CPU in float64.

`build_rcs_problem` reads the flat files of tests/test_native_loader.py's
network (40 points, 6 images, 4 datum points), here with image noise and
with rows the loader must drop (an unknown point name, an image without an
exterior orientation), a point seen by fewer images than the rest and a
repeated point name.  The JAX function keeps the observations in file
order; the port returns the feature-major engine's point-major layout
(`rcs.point_major_layout`).  So the live rows of the port, in order, must
equal the JAX observations sorted stably by point (each point's rows in
file order), exactly; pad rows carry zero weight; every other field and
the state are equal.  Then the JAX `solve` (its block-layout engine) and
the port's `solve` (feature-major engine, CPU) from the same perturbed
start end within 1e-8 in the same number of steps, and the checkpoints
they write every second step hold the same contents.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.io import columnar as JC
from bundle_adjustment_tpu.models.distortion import DistortionSpecBuilder
from bundle_adjustment_tpu.parallel import solver as JS
from bundle_adjustment_tpu.solver.checkpoint import LMCheckpoint as JCk
from bundle_adjustment_tpu_torch import synthetic
from bundle_adjustment_tpu_torch.io import columnar as TC
from bundle_adjustment_tpu_torch.io import scene_files
from bundle_adjustment_tpu_torch.parallel import rcs
from bundle_adjustment_tpu_torch.parallel import solver as TS
from bundle_adjustment_tpu_torch.solver.checkpoint import LMCheckpoint as TCk
from bundle_adjustment_tpu_torch.testing import look_at_wpk
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
P, M = 40, 6
FEWER = 5      # the point that loses two of its views
SIGMA = 1e-3


def _network(tmp_path):
    """The flat files of tests/test_native_loader.py's network (rng 7),
    with noise, dropped rows, a thinned point and a repeated name."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-5, 5, (P, 3))
    pts[:, 2] *= 0.2
    eo = np.zeros((M, 6))
    for m in range(M):
        ang = 2 * np.pi * m / M
        pos = np.array([30 * np.cos(ang), 30 * np.sin(ang), 25.0])
        w, p_, k = look_at_wpk(pos, np.zeros(3))
        eo[m] = [*pos, w, p_, k]
    io = np.array([0.0, 0.0, -30.0])
    spec = DistortionSpecBuilder().build()
    obs_point = np.repeat(np.arange(P), M)
    obs_image = np.tile(np.arange(M), P)
    keep = ~((obs_point == FEWER) & (obs_image < 2))
    obs_point, obs_image = obs_point[keep], obs_image[keep]
    xy = synthetic.predict(pts, io[None], np.zeros((1, 0)), eo, obs_point,
                           obs_image, spec)
    xy = xy + rng.normal(0, SIGMA, xy.shape)
    names = [f"T{i}" for i in range(P)]
    paths = scene_files.write_flat_files(
        str(tmp_path / "net"), names, pts, np.arange(P) < 4, obs_point,
        obs_image, xy, SIGMA, eo, io, image_ids=100 + np.arange(M))
    with open(paths["points"], "a") as fh:
        fh.write("T7 %.17g %.17g %.17g\n" % tuple(pts[7] + 0.01))
    with open(paths["imagecoords"], "a") as fh:
        fh.write("1 100 NOPE 0.1 0.2 0.001 0.001\n"
                 "1 999 T1 0.1 0.2 0.001 0.001\n"
                 "1 101 T2 %.17g %.17g 0.002 0.001 0.25\n"
                 % tuple(xy[(obs_point == 2) & (obs_image == 1)][0]))
    return paths, spec


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    paths, spec = _network(tmp_path_factory.mktemp("columnar"))
    args = (paths["points"], paths["imagecoords"], paths["eor"])
    jp, js, _ = JC.build_rcs_problem(*args, io_path=paths["ior"], spec=spec,
                                     dtype=jnp.float64)
    tp, ts, _ = TC.build_rcs_problem(*args, io_path=paths["ior"], spec=spec,
                                     device=CPU, dtype=torch.float64)
    return jp, js, tp, ts, spec, paths


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_live_rows_equal_jax_in_file_order(built):
    jp, _, tp, _, _, _ = built
    order = np.argsort(_np(jp.obs_point), kind="stable")
    w = _np(tp.obs_weight)
    live = w[:, 0, 0] > 0
    # point 2 has one more view than the rest (the rho row)
    V = M + 1
    assert tp.point_uniform == V and tp.num_points == P
    assert tp.obs_point.shape[0] == P * V
    # the thinned point: its own rows first, then zero-weight pads
    rows = slice(FEWER * V, (FEWER + 1) * V)
    assert live[rows].tolist() == [True] * (M - 2) + [False] * 3
    assert live[2 * V:3 * V].all()
    assert int(live.sum()) == jp.obs_point.shape[0]
    np.testing.assert_array_equal(_np(tp.obs_point)[live],
                                  _np(jp.obs_point)[order])
    for f in ("obs_image", "obs_xy", "obs_weight"):
        np.testing.assert_array_equal(_np(getattr(tp, f))[live],
                                      _np(getattr(jp, f))[order], err_msg=f)
    # pads carry no weight and repeat their point's first observation
    pad = np.flatnonzero(~live)
    assert not w[pad].any()
    first = pad // V * V
    for f in ("obs_image", "obs_xy"):
        np.testing.assert_array_equal(_np(getattr(tp, f))[pad],
                                      _np(getattr(tp, f))[first])
    perm, starts = rcs.build_image_block_layout(_np(tp.obs_image), M)
    np.testing.assert_array_equal(_np(tp.img_perm), perm)
    np.testing.assert_array_equal(_np(tp.img_block_starts), starts)


def test_fields_and_state_equal_jax(built):
    jp, js, tp, ts, _, _ = built
    assert (tp.num_points, tp.num_images) == (jp.num_points, jp.num_images)
    for f in ("free_point", "free_eo", "free_global", "r0", "cam_of_image"):
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      _np(getattr(jp, f)), err_msg=f)
    assert not _np(tp.r0).any()
    assert _np(tp.free_point)[:4].sum() == 0 and _np(tp.free_point)[4:].all()
    for f in ("points", "io", "dist", "eo"):
        np.testing.assert_array_equal(_np(getattr(ts, f)),
                                      _np(getattr(js, f)), err_msg=f)
    # the repeated name: first-seen order, the last row's values
    assert _np(ts.points)[7, 0] == _np(js.points)[7, 0]


def test_repeated_image_row_last_wins(tmp_path):
    """A (camera, image) pair with two EO rows: the observations go to the
    last row's image, as the JAX loader's dict does."""
    paths, spec = _network(tmp_path)
    with open(paths["eor"], "a") as fh:
        fh.write("1 102 1 2 3 0.1 0.2 0.3\n")
    args = (paths["points"], paths["imagecoords"], paths["eor"])
    jp, js, _ = JC.build_rcs_problem(*args, spec=spec, dtype=jnp.float64)
    tp, ts, _ = TC.build_rcs_problem(*args, spec=spec, device=CPU,
                                     dtype=torch.float64)
    order = np.argsort(_np(jp.obs_point), kind="stable")
    live = _np(tp.obs_weight)[:, 0, 0] > 0
    np.testing.assert_array_equal(_np(tp.obs_image)[live],
                                  _np(jp.obs_image)[order])
    assert (_np(jp.obs_image) == M).any() and tp.num_images == M + 1
    np.testing.assert_array_equal(_np(ts.eo), _np(js.eo))


def test_device_defaults_to_cuda(built):
    paths = built[5]
    args = (paths["points"], paths["imagecoords"], paths["eor"])
    if torch.cuda.is_available():
        assert TC.build_rcs_problem(*args)[0].obs_xy.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.build_rcs_problem(*args)


@pytest.fixture(scope="module")
def solved(built, tmp_path_factory):
    jp, js, tp, ts, spec, _ = built
    d = tmp_path_factory.mktemp("ck")
    rng = np.random.default_rng(3)
    dp = rng.normal(0, 0.01, (P, 3)) * _np(jp.free_point)
    kw = dict(cg_tol=1e-12, cg_maxiter=200, damping=1e-3, max_iterations=30,
              checkpoint_every=2)
    jr = JS.solve(jp, js._replace(points=js.points + jnp.asarray(dp)), spec,
                  checkpoint_path=str(d / "jax.npz"), **kw)
    tr = TS.solve(tp, ts._replace(points=ts.points + torch.as_tensor(dp)),
                  spec, checkpoint_path=str(d / "port.npz"), **kw)
    return jr, tr, JCk.load(str(d / "jax.npz")), TCk.load(str(d / "port.npz"))


def test_solve_matches_jax(solved):
    jr, tr, _, _ = solved
    assert jr.converged and tr.converged
    assert tr.iterations == jr.iterations
    for f in ("points", "io", "eo"):
        a, b = _np(getattr(tr.state, f)), _np(getattr(jr.state, f))
        assert np.abs(a - b).max() <= 1e-8, f
    np.testing.assert_allclose(tr.omega, jr.omega, rtol=1e-8)


def test_checkpoint_matches_jax(solved):
    jr, tr, jc, tc = solved
    assert tc.iteration == jc.iteration == 2 * (jr.iterations // 2)
    assert tc.adapted_damping == pytest.approx(jc.adapted_damping, rel=1e-12)
    np.testing.assert_allclose(tc.omega, jc.omega, rtol=1e-8)
    np.testing.assert_allclose(tc.max_abs_dx, jc.max_abs_dx, rtol=1e-6,
                               atol=1e-12)
    for f in ("points", "io", "dist", "eo"):
        a, b = getattr(tc.state, f), getattr(jc.state, f)
        assert a.shape == b.shape
        assert a.size == 0 or np.abs(a - b).max() <= 1e-8, f
    assert tc.centroid is None and jc.centroid is None
