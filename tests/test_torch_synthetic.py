"""The port's synthetic network equals `bench.build_problem` for the same
seed.  Tolerances: index arrays, the padding and the perturbed start are
drawn from the same rng stream, so they must be identical; the
observations come from two implementations of the same float64 forward
model (ops.fm rows vs the JAX scalar model), so they agree to rounding
(1e-9 absolute on image coordinates of a few mm).  The build gives the
same bits in every process: three fresh processes, one digest."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from bundle_adjustment_tpu_torch import synthetic
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("P,M,V,seed", [(128, 6, 4, 0), (700, 9, 5, 4)])
def test_build_problem_matches_bench(P, M, V, seed):
    import bench

    pj, sj, spec_j = bench.build_problem(P, M, V, jnp.float64, seed=seed,
                                         pad128=True)
    pt, st, spec_t = synthetic.build_problem(P, M, V, seed=seed)
    assert [(int(s.kind), s.key, s.order) for s in spec_t.slots] == \
        [(int(s.kind), s.key, s.order) for s in spec_j.slots]
    assert (pt.num_points, pt.num_images, pt.point_uniform) == \
        (pj.num_points, pj.num_images, pj.point_uniform)
    np.testing.assert_array_equal(np.asarray(pj.cam_of_image), 0)
    for f in ("obs_point", "obs_image", "img_perm", "img_block_starts"):
        np.testing.assert_array_equal(getattr(pt, f),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    for f in ("obs_weight", "r0", "free_point", "free_eo", "free_global"):
        np.testing.assert_array_equal(getattr(pt, f),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(pt.obs_xy, np.asarray(pj.obs_xy), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("C", [2, 3, 16])
def test_camera_rig_matches_bench(C):
    """`build_problem(num_cameras=C)`: image m on camera m % C, the
    per-camera true IO and distortion of `bench.build_problem`, the same
    draws; G = C (3 + K)."""
    import bench

    pj, sj, _ = bench.build_problem(300, 2 * C + 1, 4, jnp.float64, seed=C,
                                    pad128=True, num_cameras=C)
    pt, st, spec = synthetic.build_problem(300, 2 * C + 1, 4, seed=C,
                                           num_cameras=C)
    np.testing.assert_array_equal(pt.cam_of_image,
                                  np.asarray(pj.cam_of_image))
    for f in ("obs_image", "img_perm", "r0", "free_global", "obs_weight"):
        np.testing.assert_array_equal(getattr(pt, f),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    assert pt.free_global.shape == (C * (3 + spec.num_coefficients),)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(pt.obs_xy, np.asarray(pj.obs_xy), rtol=0,
                               atol=1e-9)


def test_padding_is_inert():
    """Dummy points: zero weights, fixed, copies of point 0."""
    pt, st, _ = synthetic.build_problem(100, 5, 3, seed=1)
    assert pt.num_points == 512
    assert np.all(pt.obs_weight[300:] == 0.0)
    assert np.all(pt.free_point[100:] == 0.0)
    assert np.all(st.points[100:] == st.points[0])


def test_free_network_redresses_the_true_points_only():
    """`free_network`: true points free and in the datum, dummy points
    fixed and outside it; bars between distinct true points at the true
    distance plus noise of sigma 5e-7 (weight 1e6); the same seed gives
    the same network; `true_points` is `build_problem`'s first draw."""
    P = 300
    pt, st, _ = synthetic.build_problem(P, 8, 4, seed=2)
    truth = synthetic.true_points(P, seed=2)
    # the start is the truth plus the perturbation (sigma 0.05) off the
    # three datum points, and equal to it on them
    np.testing.assert_array_equal(st.points[:3], truth[:3])
    assert 0.01 < np.abs(st.points[3:P] - truth[3:]).std() < 0.1
    fn = synthetic.free_network(pt, st, bars=8, seed=5, truth=truth)
    assert fn.has_extras and fn.num_points == 512
    assert np.all(fn.free_point[:P] == 1.0) and np.all(fn.free_point[P:] == 0)
    np.testing.assert_array_equal(fn.datum_mask_d, fn.free_point[:, 0])
    assert fn.defect_flags_d == (True,) * 6 + (False,)
    ends = np.concatenate([fn.sb_a, fn.sb_b])
    assert ends.max() < P and len(set(ends.tolist())) == 16
    d = np.linalg.norm(truth[fn.sb_b] - truth[fn.sb_a], axis=1)
    err = fn.sb_length - d
    assert np.all(np.abs(err) < 5 * 5e-7) and np.any(err != 0.0)
    assert np.all(fn.sb_weight == synthetic.BAR_WEIGHT)
    again = synthetic.free_network(pt, st, bars=8, seed=5, truth=truth)
    np.testing.assert_array_equal(again.sb_length, fn.sb_length)
    # without the truth, the bars take the state's distances
    fs = synthetic.free_network(pt, st, bars=8, seed=5)
    ds = np.linalg.norm(st.points[fs.sb_b] - st.points[fs.sb_a], axis=1)
    assert np.all(np.abs(fs.sb_length - ds) < 5 * 5e-7)


def test_free_network_direct_observations():
    """The populated group (cofactor U^T U, SPD), the diagonal dp / de /
    dg observations (weight (5e-4 / sigma)^2 where observed, 0 elsewhere)
    and the fixed-coordinate datum kept with ``datum=False``."""
    pt, st, _ = synthetic.build_problem(300, 8, 4, seed=2)
    fn = synthetic.free_network(
        pt, st, bars=0, datum=False, seed=1,
        direct=dict(group=30, dp=10, de=3, dg=True))
    assert fn.has_extras and fn.sb_a is None and fn.datum_mask_d is None
    np.testing.assert_array_equal(fn.free_point, pt.free_point)
    assert fn.dpg_cov.shape == (30, 30) and fn.dpg_idx.max() < 300
    assert np.linalg.eigvalsh(fn.dpg_cov).min() > 0
    np.testing.assert_array_equal(fn.dpg_cov, fn.dpg_cov.T)
    assert set(fn.dpg_axis.tolist()) <= {0, 1, 2}
    assert (fn.dp_w.sum(axis=1) > 0).sum() == 10
    assert np.all(fn.dp_w[300:] == 0) and np.all(fn.dp_w[fn.dp_w > 0] == 0.25)
    np.testing.assert_array_equal(fn.dp_val[fn.dp_w == 0],
                                  st.points[fn.dp_w == 0])
    assert (fn.de_w.sum(axis=1) > 0).sum() == 3
    assert np.all(fn.dg_w[:3] == 0.25) and np.all(fn.dg_w[3:] == 0)
    with pytest.raises(ValueError, match="unknown"):
        synthetic.free_network(pt, st, direct=dict(points=3))


def test_build_keeps_its_bits_across_processes():
    """`build_problem(20_000, 100, 12)` in three fresh processes started
    together: one SHA-256 digest of every array (`synthetic.digest`).
    Two torch threads each: threaded, without oversubscribing the cores
    that the suite's workers share."""
    code = ("import torch; torch.set_num_threads(2); "
            "from bundle_adjustment_tpu_torch import synthetic; "
            "p, s, _ = synthetic.build_problem(20_000, 100, 12); "
            "print(synthetic.digest(p, s))")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    digests = {out.strip() for out, _ in outs}
    assert len(digests) == 1 and len(digests.pop()) == 64
