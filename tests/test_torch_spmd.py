"""The port's observation-sharded step (`parallel/spmd.py`) on 1, 2 and 5
CPU ranks (gloo, spawned) against the JAX `spmd` step on the 8-device CPU
mesh, at the tolerances of tests/test_spmd.py: max_dx rtol 1e-8, points
and eo atol 1e-9; omega0 rtol 1e-10 (Gauss-Newton, cg_tol 1e-13).  Every
rank holds the same bits of the replicated state.  The networks, each run
by the same spawned ranks:

* the scene of tests/test_spmd.py (24 points, 6 images, seed 61, the
  first three points fixed) in the port's point-major layout (its 144
  rows split into shards of 29 at 5 ranks, so shards split points) and in
  JAX's own file order (`compile_problem`'s);
* a network of uneven visibility in file order:
  `synthetic.build_problem(240, 12, 12, seed=5)` cut by
  `synthetic.thin_views(views=6, every=10)` (6 to 12 views per point,
  rows grouped by image: every shard holds rows of points that other
  shards hold too); the JAX step takes the same host arrays.

Without spawning: `shard_problem` takes a file-order problem (each rank
ceil(N / D) rows in the problem's order, zero-weight pad rows only in the
last shard), refuses direct observations, and the step takes `solve`'s
file-route `use_kernels` (naming K1 raises).
"""

import types

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch.parallel import multihost, rcs, spmd
from _torch_threads import one_torch_thread  # noqa: F401

RANKS = (1, 2, 5)
TIMEOUT = 120
CG_TOL, CG_MAXITER = 1e-13, 1000
UNEVEN = dict(shape=(240, 12, 12), seed=5, views=6, every=10)


def _scene(layout=None):
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
    return (rcs.rcs_from_problem(cs.problem, "cpu", layout=layout), state,
            cs.problem.spec)


def _uneven_host():
    from bundle_adjustment_tpu_torch import synthetic

    ph, sh, spec = synthetic.build_problem(*UNEVEN["shape"],
                                           seed=UNEVEN["seed"])
    ph, sh = synthetic.thin_views(ph, sh, views=UNEVEN["views"],
                                  every=UNEVEN["every"])
    return ph, sh, spec


def _uneven():
    from bundle_adjustment_tpu_torch import convert

    ph, sh, spec = _uneven_host()
    return (convert.problem_to_torch(ph, "cpu", torch.float64),
            convert.state_to_torch(sh, "cpu", torch.float64), spec)


def _worker(comm):
    out = {}
    for name, (problem, state, spec) in (
            ("point_major", _scene()), ("file", _scene("file")),
            ("uneven", _uneven())):
        sp = spmd.shard_problem(problem, comm)
        step = spmd.make_spmd_lm_step(sp, spec, comm, cg_tol=CG_TOL,
                                      cg_maxiter=CG_MAXITER)
        new, max_dx, omega0, it = step(state)
        out[name] = dict(
            new=new, max_dx=float(max_dx), omega0=float(omega0), it=it,
            rows=int(sp.problem.obs_point.shape[0]), real=sp.rows,
            layout=problem.point_uniform,
            points=set(sp.problem.obs_point[:sp.rows].tolist()))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {D: multihost.run_ranks(
        _worker, D, device="cpu", timeout=TIMEOUT,
        workdir=tmp_path_factory.mktemp(f"spmd{D}")) for D in RANKS}


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX `spmd` step on the 8-device CPU mesh: the scene of
    tests/test_spmd.py in its file order, and the uneven network."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bundle_adjustment_tpu.models.distortion import DistortionSpecBuilder
    from bundle_adjustment_tpu.models.layout import assign_columns
    from bundle_adjustment_tpu.models.problem import (ParamState,
                                                      compile_problem)
    from bundle_adjustment_tpu.parallel import rcs as R
    from bundle_adjustment_tpu.parallel import spmd as J
    from bundle_adjustment_tpu.testing import make_synthetic_scene

    mesh = Mesh(np.array(jax.devices()), ("obs",))

    def run(problem, state, spec):
        step = J.make_spmd_lm_step(J.shard_problem(problem, mesh), spec,
                                   mesh, cg_tol=CG_TOL,
                                   cg_maxiter=CG_MAXITER)
        new, max_dx, omega0, it = step(ParamState(
            *(jnp.asarray(a, jnp.float64) for a in state)))
        return dict(new=[np.asarray(a) for a in new], max_dx=float(max_dx),
                    omega0=float(omega0))

    cameras, _, truth = make_synthetic_scene(
        num_points=24, num_images=6, noise=1e-4, sigma=1e-4,
        perturb=0.005, seed=61, with_scale_bar=False)
    for oc in truth["coords"][:3]:
        for p in oc.params:
            p.fixed = True
    cs = compile_problem(cameras, [], [], assign_columns(cameras, [], []))
    scene = run(R.rcs_from_problem(cs.problem, build_tables=False),
                cs.state, cs.problem.spec)

    ph, sh, _ = _uneven_host()
    builder = DistortionSpecBuilder()  # synthetic.scale_spec's stack
    builder.add_affinity()
    builder.add_tangential()
    for order in (1, 2, 3):
        builder.add_radial_order(order)
    problem = R.RCSProblem(**{
        f: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        for f, v in ph._asdict().items() if f in R.RCSProblem._fields
        and f not in ("img_perm", "img_block_starts")})
    return {"file": scene, "point_major": scene,
            "uneven": run(problem, sh, builder.build())}


def _check(res, ref):
    assert np.isclose(res["max_dx"], ref["max_dx"], rtol=1e-8)
    points, io, dist, eo = ref["new"]
    np.testing.assert_allclose(res["new"].points.numpy(), points, atol=1e-9,
                               rtol=0)
    np.testing.assert_allclose(res["new"].eo.numpy(), eo, atol=1e-9, rtol=0)
    np.testing.assert_allclose(res["new"].io.numpy(), io, atol=1e-9, rtol=0)
    np.testing.assert_allclose(res["omega0"], ref["omega0"], rtol=1e-10)


def _same_on_every_rank(results, name):
    res = results[0][name]
    for other in results[1:]:
        o = other[name]
        assert o["it"] == res["it"] and o["max_dx"] == res["max_dx"]
        assert o["omega0"] == res["omega0"]
        for f in ("points", "io", "dist", "eo"):
            assert torch.equal(getattr(o["new"], f), getattr(res["new"], f))


@pytest.mark.parametrize("D", RANKS)
def test_spmd_step_matches_jax(ranks, jax_steps, D):
    assert ranks[D][0]["point_major"]["layout"] == 6
    _check(ranks[D][0]["point_major"], jax_steps["point_major"])
    _same_on_every_rank(ranks[D], "point_major")


@pytest.mark.parametrize("D", RANKS)
def test_spmd_file_order_step_matches_jax(ranks, jax_steps, D):
    assert ranks[D][0]["file"]["layout"] is None
    _check(ranks[D][0]["file"], jax_steps["file"])
    _same_on_every_rank(ranks[D], "file")


@pytest.mark.parametrize("D", RANKS)
def test_spmd_uneven_step_matches_jax(ranks, jax_steps, D):
    assert ranks[D][0]["uneven"]["layout"] is None
    _check(ranks[D][0]["uneven"], jax_steps["uneven"])
    _same_on_every_rank(ranks[D], "uneven")


def test_shards_split_points(ranks):
    rows = [r["point_major"]["rows"] for r in ranks[5]]
    assert rows == [29] * 5 and 29 % 6 != 0
    for name in ("point_major", "file", "uneven"):
        seen = [r[name]["points"] for r in ranks[5]]
        assert any(seen[a] & seen[b] for a in range(5)
                   for b in range(a + 1, 5)), name


@pytest.mark.parametrize("D", RANKS)
def test_shard_problem_takes_file_order(D):
    problem, _, _ = _uneven()
    assert problem.point_uniform is None
    N = int(problem.obs_point.shape[0])
    n = -(-N // D)
    got = []
    for r in range(D):
        sp = spmd.shard_problem(problem, types.SimpleNamespace(
            size=D, rank=r, device=torch.device("cpu")))
        lp = sp.problem
        assert lp.obs_point.shape[0] == n and sp.offset == r * n
        assert lp.point_uniform is None and lp.point_order is not None
        real = slice(r * n, r * n + sp.rows)
        for f in ("obs_point", "obs_image", "obs_xy", "obs_weight"):
            assert torch.equal(getattr(lp, f)[:sp.rows].to(
                getattr(problem, f).dtype), getattr(problem, f)[real]), f
        pad = lp.obs_weight[sp.rows:]
        assert (sp.rows == n) == (r < D - 1 or N % D == 0)
        assert not pad.any() and not lp.obs_point[sp.rows:].any() \
            and not lp.obs_image[sp.rows:].any()
        got.append(lp.obs_xy[:sp.rows])
    assert sp.rows_padded == n * D
    assert torch.equal(torch.cat(got), problem.obs_xy)


def test_shard_problem_refuses_direct_observations():
    problem, _, _ = _scene()
    comm = types.SimpleNamespace(size=2, rank=0, device="cpu")
    with pytest.raises(ValueError, match="image observations only"):
        spmd.shard_problem(problem._replace(
            dp_w=torch.zeros((24, 3), dtype=torch.float64)), comm)


def test_step_takes_the_file_routes_kernels():
    """``use_kernels`` as `solve`'s on the file order: K1 / K2 raise,
    K3 (the plain gather for CPU tensors) runs."""
    problem, state, spec = _scene("file")
    sp = spmd.shard_problem(problem, types.SimpleNamespace(
        size=1, rank=0, device=torch.device("cpu")))
    for names in (("K1",), ("K2", "K3")):
        with pytest.raises(ValueError, match="'file' layout"):
            spmd.make_spmd_lm_step(sp, spec, None, use_kernels=names)
    for use in (("K3",), True, False, None):
        assert callable(spmd.make_spmd_lm_step(sp, spec, None,
                                               use_kernels=use))
