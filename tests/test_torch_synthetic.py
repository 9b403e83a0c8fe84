"""The port's synthetic network equals `bench.build_problem` for the same
seed.  Tolerances: index arrays, the padding and the perturbed start are
drawn from the same rng stream, so they must be identical; the
observations come from two implementations of the same float64 forward
model (ops.fm rows vs the JAX scalar model), so they agree to rounding
(1e-9 absolute on image coordinates of a few mm)."""

import jax.numpy as jnp
import numpy as np
import pytest

from bundle_adjustment_tpu_torch import synthetic


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


def test_padding_is_inert():
    """Dummy points: zero weights, fixed, copies of point 0."""
    pt, st, _ = synthetic.build_problem(100, 5, 3, seed=1)
    assert pt.num_points == 512
    assert np.all(pt.obs_weight[300:] == 0.0)
    assert np.all(pt.free_point[100:] == 0.0)
    assert np.all(st.points[100:] == st.points[0])
