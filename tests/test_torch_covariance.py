"""Covariance blocks on demand (`parallel/covariance.py`) against the JAX
`parallel/covariance.py` and the dense inverse, on the CPU in f64.

The scene of tests/test_covariance_on_demand.py (25 points, 6 images,
three points held fixed, converged by Gauss-Newton; its JAX side computed
once in the module fixture): the port reads the JAX `BundleProblem`
through `rcs.rcs_from_problem` and linearises at the JAX converged state.
Tolerances: against the JAX functions rtol 1e-6 at PCG tol 1e-12 (two
PCGs with other preconditioners stop at 1e-12 relative); against the
dense bordered inverse rtol 1e-5, atol 1e-12 (the JAX test's).  On a
3-camera rig (the compact rows, block-Jacobi preconditioner: the coupled
one is indefinite there) the blocks are held against the port's
`cov_direct` (dense S^-1) at rtol 1e-6, atol 1e-9 of each set's largest
entry; the view-major layout and a chunked rhs axis give the same blocks
at rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_covariance_on_demand import _setup
from test_torch_parity import CPU, np_
from bundle_adjustment_tpu.parallel import covariance as JC
from bundle_adjustment_tpu.parallel import rcs as JR
from bundle_adjustment_tpu_torch import convert, synthetic
from bundle_adjustment_tpu_torch.parallel import cov_direct, covariance
from bundle_adjustment_tpu_torch.parallel import engine, rcs
from _torch_threads import one_torch_thread  # noqa: F401

POINTS = np.array([3, 7, 20], np.int32)
IMAGES = np.array([0, 4], np.int32)
PAIRS = np.array([[3, 7], [20, 5]])
TOL = dict(tol=1e-12, maxiter=2000)


@pytest.fixture(scope="module")
def scene():
    """The JAX side: the converged scene, its dense Q and the JAX blocks."""
    bp, rp, state, Q = _setup()
    blocks = JR.linearize(rp, state, bp.spec, 0.0)
    return dict(
        bp=bp, state=state, Q=Q,
        points=np.asarray(JC.point_covariance_blocks(rp, blocks, POINTS,
                                                     **TOL)),
        cameras=np.asarray(JC.camera_covariance_blocks(rp, blocks, IMAGES,
                                                       **TOL)),
        pairs=np.asarray(JC.point_pair_covariance_blocks(rp, blocks, PAIRS,
                                                         **TOL)))


def _port(scene, view_major=None):
    fmp = engine.fm_problem(rcs.rcs_from_problem(scene["bp"], CPU))
    if view_major:
        fmp = engine.to_view_major(fmp, view_major)
    st = convert.state_to_torch(scene["state"], CPU, torch.float64)
    b, Minv = covariance.prepare(fmp, st, scene["bp"].spec)
    return fmp, b, Minv


def _dense(scene, a, c):
    return scene["Q"][np.ix_(a, c)]


def test_point_blocks_match_jax_and_dense(scene):
    fmp, b, Minv = _port(scene)
    stats = {}
    Qb = np_(covariance.point_covariance_blocks(fmp, b, Minv, POINTS,
                                                stats=stats, **TOL))
    assert 0 < stats["iterations"] < TOL["maxiter"]
    np.testing.assert_allclose(Qb, scene["points"], rtol=1e-6)
    cols = scene["bp"].col_points
    for j, pid in enumerate(POINTS):
        assert (cols[pid] >= 0).all()
        np.testing.assert_allclose(Qb[j], _dense(scene, cols[pid], cols[pid]),
                                   rtol=1e-5, atol=1e-12)


def test_camera_blocks_match_jax_and_dense(scene):
    fmp, b, Minv = _port(scene)
    Qb = np_(covariance.camera_covariance_blocks(fmp, b, Minv, IMAGES,
                                                 **TOL))
    np.testing.assert_allclose(Qb, scene["cameras"], rtol=1e-6)
    cols = scene["bp"].col_eo
    for j, mid in enumerate(IMAGES):
        np.testing.assert_allclose(Qb[j], _dense(scene, cols[mid], cols[mid]),
                                   rtol=1e-5, atol=1e-12)


def test_pair_blocks_match_jax_and_dense(scene):
    fmp, b, Minv = _port(scene)
    Qb = np_(covariance.point_pair_covariance_blocks(fmp, b, Minv, PAIRS,
                                                     **TOL))
    np.testing.assert_allclose(Qb, scene["pairs"], rtol=1e-6)
    cols = scene["bp"].col_points
    for j, (p, q) in enumerate(PAIRS):
        np.testing.assert_allclose(Qb[j], _dense(scene, cols[p], cols[q]),
                                   rtol=1e-5, atol=1e-12)


def test_view_major_layout_and_rhs_chunks_agree(scene, monkeypatch):
    """The selected points' lanes in the view-major layout, and a batched
    matvec chunked one rhs at a time, give the same blocks."""
    fmp, b, Minv = _port(scene)
    ref = np_(covariance.point_covariance_blocks(fmp, b, Minv, POINTS,
                                                 **TOL))
    fv, bv, Mv = _port(scene, view_major=5)
    assert fv.vm_pb == 5
    np.testing.assert_allclose(
        np_(covariance.point_covariance_blocks(fv, bv, Mv, POINTS, **TOL)),
        ref, rtol=1e-9)
    monkeypatch.setattr(covariance, "MATVEC_BYTES", 1.0)
    np.testing.assert_allclose(
        np_(covariance.point_covariance_blocks(fmp, b, Minv, POINTS, **TOL)),
        ref, rtol=1e-9)


@pytest.fixture(scope="module")
def rig():
    """A 3-camera rig (compact rows) and the port's dense covariance."""
    import bench

    problem, state, spec = bench.build_problem(256, 12, 6, jnp.float64,
                                               seed=11, num_cameras=3)
    fmp = engine.fm_problem(convert.problem_to_torch(problem, CPU,
                                                     torch.float64))
    st = convert.state_to_torch(state, CPU, torch.float64)
    b0 = engine.linearize(fmp, st, spec, 0.0)
    Qred = cov_direct.reduced_inverse(cov_direct.assemble_reduced_dense(fmp,
                                                                        b0))
    return fmp, st, spec, b0, Qred


def test_rig_blocks_match_cov_direct(rig):
    """The rig's coupled preconditioner has an indefinite global Schur
    complement, so `prepare` falls back to block Jacobi."""
    fmp, st, spec, b0, Qred = rig
    b, Minv = covariance.prepare(fmp, st, spec)
    assert b.Jg is None and Minv.Scg is None
    coupled = engine.prepare(fmp, st, spec, 0.0, couple_global=True)[3]
    assert (torch.linalg.eigvalsh(coupled.Sghat_inv) < 0).any()
    ids = np.array([4, 100, 255])
    pairs = np.array([[4, 100], [7, 200]])
    images = np.array([0, 5, 11])
    for got, ref in (
            (covariance.point_covariance_blocks(fmp, b, Minv, ids, **TOL),
             cov_direct.point_covariance_dense(fmp, b0, Qred,
                                               torch.as_tensor(ids))),
            (covariance.point_pair_covariance_blocks(fmp, b, Minv, pairs,
                                                     **TOL),
             cov_direct.point_pair_covariance_dense(fmp, b0, Qred, pairs)),
            (covariance.camera_covariance_blocks(fmp, b, Minv, images,
                                                 **TOL),
             cov_direct.camera_covariance_dense(Qred, images))):
        ref = np_(ref)
        np.testing.assert_allclose(np_(got), ref, rtol=1e-6,
                                   atol=1e-9 * np.abs(ref).max())


@pytest.mark.parametrize("cameras, coupled", [(1, True), (3, False)])
def test_prepare_keeps_the_preconditioner_definite(cameras, coupled):
    """`prepare` keeps the coupled preconditioner where its global Schur
    complement is positive definite (one camera at 2,000 / 40 / 12) and
    falls back to block Jacobi where it is not (a 3-camera rig)."""
    prob_h, state_h, spec = synthetic.build_problem(2000, 40, 12, seed=0,
                                                    num_cameras=cameras)
    fmp = engine.fm_problem(convert.problem_to_torch(prob_h, CPU,
                                                     torch.float64))
    st = convert.state_to_torch(state_h, CPU, torch.float64)
    _, Minv = covariance.prepare(fmp, st, spec)
    Sh = engine.prepare(fmp, st, spec, 0.0, couple_global=True)[3].Sghat_inv
    definite = bool((torch.linalg.eigvalsh(Sh) > 0).all())
    assert definite == coupled
    assert (Minv.Scg is not None) == coupled


def test_extras_refused():
    """Scale bars / an inner-constraint datum: the reduced system here
    carries none of them, so every entry point raises."""
    prob_h, state_h, spec = synthetic.build_problem(100, 6, 4, seed=1)
    net = synthetic.free_network(prob_h, state_h, bars=2, seed=2)
    fmp = engine.fm_problem(convert.problem_to_torch(net, CPU,
                                                     torch.float64))
    st = convert.state_to_torch(state_h, CPU, torch.float64)
    with pytest.raises(NotImplementedError, match="scale bars"):
        covariance.prepare(fmp, st, spec)
    b, _, _, Minv = engine.prepare(fmp, st, spec, 0.0, couple_global=True)
    for fn, arg in ((covariance.point_covariance_blocks, [0]),
                    (covariance.point_pair_covariance_blocks, [[0, 1]]),
                    (covariance.camera_covariance_blocks, [0])):
        with pytest.raises(NotImplementedError, match="scale bars"):
            fn(fmp, b, Minv, arg)
