"""The port's point-sharded feature-major step (`parallel/spmd_fm.py`) on
1, 2 and 4 CPU ranks (gloo, spawned over a ``file://`` store) against the
JAX `spmd_fm` on the 8-device CPU mesh and against the port's own
`engine.lm_step`, float64, `bench.build_problem(512, 24, 8, seed=3)` (the
port builds the same network with `synthetic.build_problem`).

Tolerances are those of tests/test_spmd.py: points and eo rtol 1e-9 /
atol 1e-11, io rtol 1e-9 / atol 1e-12, omega0 rtol 1e-10, max_dx rtol
1e-7; the ragged-image case rtol 1e-8 / atol 1e-10 and the dummy images'
EO unchanged.  Each rank count runs the replicated and the ``cam_shard``
step and two more iterations of each (omega falls).  The rank workers
import torch, numpy and the port only; the JAX side lives in a fixture.
"""

import hashlib

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch import convert, synthetic
from bundle_adjustment_tpu_torch.parallel import engine, multihost, rcs, \
    spmd_fm

SHAPE = (512, 24, 8)
DAMPING, CG_TOL, CG_MAXITER = 1e-4, 1e-12, 500
RANKS = (1, 2, 4)
MODES = ("replicated", "cam_shard")
TIMEOUT = 120


def _problem(num_images=SHAPE[1]):
    ph, sh, spec = synthetic.build_problem(SHAPE[0], num_images, SHAPE[2],
                                           seed=3)
    return (convert.problem_to_torch(ph, "cpu", torch.float64),
            convert.state_to_torch(sh, "cpu", torch.float64), spec)


def _run(comm, prob, st, spec, cam_shard, images=False):
    prob, st, _ = spmd_fm.pad_for_mesh(prob, st, comm, images=images)
    step, args = spmd_fm.make_spmd_fm_lm_step(
        prob, st, spec, comm, damping=DAMPING, cg_tol=CG_TOL,
        cg_maxiter=CG_MAXITER, cam_shard=cam_shard)
    (pts, io, dist, eo), mdx, om, it = step(*args)
    out = dict(points=comm.all_gather(pts), io=io, dist=dist, eo=eo,
               max_dx=float(mdx), omega0=float(om), it=it)
    nxt = (pts, io, dist, eo)
    for _ in range(2):
        nxt, mdx2, om2, _it = step(*nxt)
    out.update(max_dx3=float(mdx2), omega3=float(om2))
    return out


def _worker(comm):
    prob, st, spec = _problem()
    res = {m: _run(comm, prob, st, spec, m == "cam_shard") for m in MODES}
    if comm.size > 1:
        ragged, st_r, spec = _problem(SHAPE[1] - 1)
        p1, s1, _ = spmd_fm.pad_for_mesh(ragged, st_r, comm)
        try:
            spmd_fm.make_spmd_fm_lm_step(p1, s1, spec, comm, cam_shard=True)
            res["ragged_error"] = None
        except ValueError as exc:
            res["ragged_error"] = str(exc)
        res["ragged"] = _run(comm, ragged, st_r, spec, True, images=True)
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {D: multihost.run_ranks(
        _worker, D, workdir=tmp_path_factory.mktemp(f"ranks{D}"),
        device="cpu", timeout=TIMEOUT) for D in RANKS}


@pytest.fixture(scope="module")
def reference():
    """The port's single-process engine.lm_step on the same network."""
    prob, st, spec = _problem()
    dxp, dxc, dxg, b, it = engine.lm_step(
        engine.fm_problem(prob), st, spec, DAMPING, cg_tol=CG_TOL,
        cg_maxiter=CG_MAXITER)
    st1, mdx = rcs.apply_step(st, dxp, dxc, dxg)
    return dict(points=st1.points, io=st1.io, dist=st1.dist, eo=st1.eo,
                max_dx=float(mdx), omega0=float(b.omega0), it=it)


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import bench as B
    from bundle_adjustment_tpu.parallel import spmd_fm as J

    problem, state, spec = B.build_problem(*SHAPE, jnp.float64, seed=3)
    mesh = Mesh(np.array(jax.devices()[:8]), ("pts",))
    problem, state, _ = J.pad_for_mesh(problem, state, mesh)
    out = {}
    for mode in MODES:
        step, args0 = J.make_spmd_fm_lm_step(
            problem, state, spec, mesh, damping=DAMPING, cg_tol=CG_TOL,
            cg_maxiter=CG_MAXITER, cam_shard=mode == "cam_shard")
        (pts, io, dist, eo), mdx, om, it = step(*args0)
        out[mode] = dict(points=np.asarray(pts), io=np.asarray(io),
                         dist=np.asarray(dist), eo=np.asarray(eo),
                         max_dx=float(mdx), omega0=float(om), it=int(it),
                         state=tuple(np.asarray(a) for a in args0))
    return out


def _close(got, ref, ragged=False):
    r = dict(rtol=1e-8, atol=1e-10) if ragged else dict(rtol=1e-9,
                                                        atol=1e-11)
    np.testing.assert_allclose(np.asarray(got["points"]),
                               np.asarray(ref["points"]), **r)
    M = np.asarray(ref["eo"]).shape[0]
    np.testing.assert_allclose(np.asarray(got["eo"])[:M],
                               np.asarray(ref["eo"]), **r)
    np.testing.assert_allclose(np.asarray(got["io"]), np.asarray(ref["io"]),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["omega0"], ref["omega0"], rtol=1e-10)
    if not ragged:
        np.testing.assert_allclose(got["max_dx"], ref["max_dx"], rtol=1e-7)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", RANKS)
def test_spmd_fm_matches_engine_step(ranks, reference, D, mode):
    """Every rank count and mode against the port's single-process step;
    every rank holds the same replicated results; the step composes."""
    res = [r[mode] for r in ranks[D]]
    _close(res[0], reference)
    for r in res[1:]:
        assert r["omega0"] == res[0]["omega0"] and r["it"] == res[0]["it"]
        assert torch.equal(r["eo"], res[0]["eo"])
    assert np.isfinite(res[0]["max_dx3"])
    assert res[0]["omega3"] < res[0]["omega0"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", RANKS)
def test_spmd_fm_matches_jax(ranks, jax_side, D, mode):
    _close(ranks[D][0][mode], jax_side[mode])


def test_point_shard_carries_the_jax_state(jax_side, tmp_path):
    """convert.point_shard gives each rank its points of a state gathered
    on the host; the concatenation is the whole state."""
    import types

    pts, io, dist, eo = jax_side["replicated"]["state"]
    parts = [convert.point_shard((pts, io, dist, eo),
                                 types.SimpleNamespace(size=4, rank=r,
                                                       device="cpu"))
             for r in range(4)]
    np.testing.assert_array_equal(
        torch.cat([p[0] for p in parts]).numpy(), pts)
    np.testing.assert_array_equal(parts[3][3].numpy(), eo)


def test_cam_shard_ragged_images(ranks):
    """A ragged image count is refused without image padding; padded with
    fully fixed dummy images the TP step matches the unpadded step on the
    real rows and the dummies take no step."""
    res = ranks[2][0]
    assert res["ragged_error"] is not None and "cam_shard" in \
        res["ragged_error"]
    prob, st, spec = _problem(SHAPE[1] - 1)
    dxp, dxc, dxg, b, _ = engine.lm_step(
        engine.fm_problem(prob), st, spec, DAMPING, cg_tol=CG_TOL,
        cg_maxiter=CG_MAXITER)
    st1, _ = rcs.apply_step(st, dxp, dxc, dxg)
    got = res["ragged"]
    assert got["eo"].shape[0] == SHAPE[1]
    _close(got, dict(points=st1.points, io=st1.io, eo=st1.eo,
                     omega0=float(b.omega0)), ragged=True)
    torch.testing.assert_close(got["eo"][SHAPE[1] - 1:],
                               st.eo[:1], rtol=0, atol=0)


def test_world_size_one_is_the_engine_step(ranks):
    """At one rank the sharded step sums in the engine's order: the same
    bits as engine.lm_step computed with one thread, as the rank runs."""
    prob, st, spec = _problem()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dxp, dxc, dxg, b, it = engine.lm_step(
            engine.fm_problem(prob), st, spec, DAMPING, cg_tol=CG_TOL,
            cg_maxiter=CG_MAXITER)
    finally:
        torch.set_num_threads(threads)
    for mode in MODES:
        got = ranks[1][0][mode]
        assert got["it"] == it
        assert torch.equal(got["points"], st.points + dxp)
        assert torch.equal(got["eo"], st.eo + dxc)


#: sha256 of engine.lm_step's (dxp, dxc, dxg, omega0, iterations) on three
#: problems (one camera coupled, two cameras coupled, one camera block
#: Jacobi), float64, one CPU thread, computed on the engine before the
#: ``comm`` / ``cam_scatter`` hooks existed
LM_STEP_DIGEST = \
    "fa735f85a8d03db315b5e0626ba0447fb2805808e1caa75ca200433005959444"


def test_comm_none_keeps_the_engine_step_bits():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    h = hashlib.sha256()
    try:
        for C, couple in ((1, True), (2, True), (1, False)):
            ph, sh, spec = synthetic.build_problem(*SHAPE, seed=3,
                                                   num_cameras=C)
            prob = convert.problem_to_torch(ph, "cpu", torch.float64)
            st = convert.state_to_torch(sh, "cpu", torch.float64)
            out = engine.lm_step(engine.fm_problem(prob), st, spec, DAMPING,
                                 cg_tol=CG_TOL, cg_maxiter=CG_MAXITER,
                                 couple_global=couple)
            for t in (out[0], out[1], out[2], out[3].omega0):
                h.update(t.contiguous().numpy().tobytes())
            h.update(str(out[4]).encode())
    finally:
        torch.set_num_threads(threads)
    assert h.hexdigest() == LM_STEP_DIGEST
