"""The port's observation-sharded step (`parallel/spmd.py`) on 1, 2 and 5
CPU ranks (gloo, spawned) against the JAX `spmd` step on the 8-device CPU
mesh, on the scene of tests/test_spmd.py (24 points, 6 images, seed 61,
the first three points fixed, Gauss-Newton, cg_tol 1e-13), at its
tolerances: max_dx rtol 1e-8, points and eo atol 1e-9; omega0 rtol 1e-10.
At 5 ranks the 144 observation rows split into shards of 29, so shards
split points.  Every rank holds the same bits of the replicated state.
"""

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch.parallel import multihost, rcs, spmd

RANKS = (1, 2, 5)
TIMEOUT = 120
CG_TOL, CG_MAXITER = 1e-13, 1000


def _scene():
    from bundle_adjustment_tpu_torch.models.layout import assign_columns
    from bundle_adjustment_tpu_torch.models.problem import (ParamState,
                                                            compile_problem)
    from bundle_adjustment_tpu_torch.testing import make_synthetic_scene

    cameras, _, truth = make_synthetic_scene(
        num_points=24, num_images=6, noise=1e-4, sigma=1e-4,
        perturb=0.005, seed=61, with_scale_bar=False)
    for oc in truth["coords"][:3]:
        for p in oc.params:
            p.fixed = True
    cs = compile_problem(cameras, [], [], assign_columns(cameras, [], []))
    state = ParamState(*(torch.as_tensor(np.asarray(a, np.float64))
                         for a in cs.state))
    return rcs.rcs_from_problem(cs.problem, "cpu"), state, cs.problem.spec


def _worker(comm):
    problem, state, spec = _scene()
    sp = spmd.shard_problem(problem, comm)
    step = spmd.make_spmd_lm_step(sp, spec, comm, cg_tol=CG_TOL,
                                  cg_maxiter=CG_MAXITER)
    new, max_dx, omega0, it = step(state)
    return dict(new=new, max_dx=float(max_dx), omega0=float(omega0), it=it,
                rows=sp.lane.shape[0])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {D: multihost.run_ranks(
        _worker, D, device="cpu", timeout=TIMEOUT,
        workdir=tmp_path_factory.mktemp(f"spmd{D}")) for D in RANKS}


@pytest.fixture(scope="module")
def jax_step():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bundle_adjustment_tpu.models.layout import assign_columns
    from bundle_adjustment_tpu.models.problem import (ParamState,
                                                      compile_problem)
    from bundle_adjustment_tpu.parallel import rcs as R
    from bundle_adjustment_tpu.parallel import spmd as J
    from bundle_adjustment_tpu.testing import make_synthetic_scene

    cameras, _, truth = make_synthetic_scene(
        num_points=24, num_images=6, noise=1e-4, sigma=1e-4,
        perturb=0.005, seed=61, with_scale_bar=False)
    for oc in truth["coords"][:3]:
        for p in oc.params:
            p.fixed = True
    cs = compile_problem(cameras, [], [], assign_columns(cameras, [], []))
    state = ParamState(*(jnp.asarray(a, jnp.float64) for a in cs.state))
    mesh = Mesh(np.array(jax.devices()), ("obs",))
    rp = J.shard_problem(R.rcs_from_problem(cs.problem, build_tables=False),
                         mesh)
    step = J.make_spmd_lm_step(rp, cs.problem.spec, mesh, cg_tol=CG_TOL,
                               cg_maxiter=CG_MAXITER)
    new, max_dx, omega0, it = step(state)
    return dict(new=[np.asarray(a) for a in new], max_dx=float(max_dx),
                omega0=float(omega0))


@pytest.mark.parametrize("D", RANKS)
def test_spmd_step_matches_jax(ranks, jax_step, D):
    res = ranks[D][0]
    assert np.isclose(res["max_dx"], jax_step["max_dx"], rtol=1e-8)
    points, io, dist, eo = jax_step["new"]
    np.testing.assert_allclose(res["new"].points.numpy(), points, atol=1e-9,
                               rtol=0)
    np.testing.assert_allclose(res["new"].eo.numpy(), eo, atol=1e-9, rtol=0)
    np.testing.assert_allclose(res["new"].io.numpy(), io, atol=1e-9, rtol=0)
    np.testing.assert_allclose(res["omega0"], jax_step["omega0"], rtol=1e-10)
    for other in ranks[D][1:]:
        assert other["it"] == res["it"] and other["max_dx"] == res["max_dx"]
        assert torch.equal(other["new"].points, res["new"].points)


def test_shards_split_points(ranks):
    rows = [r["rows"] for r in ranks[5]]
    assert rows == [29] * 5 and 29 % 6 != 0


def test_shard_problem_refuses_direct_observations():
    import types

    problem, _, _ = _scene()
    comm = types.SimpleNamespace(size=2, rank=0, device="cpu")
    with pytest.raises(ValueError, match="image observations only"):
        spmd.shard_problem(problem._replace(
            dp_w=torch.zeros((24, 3), dtype=torch.float64)), comm)
