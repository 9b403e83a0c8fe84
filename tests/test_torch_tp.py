"""The port's block-cyclic distributed Cholesky (`parallel/tp.py`) on 1 and
2 CPU ranks (gloo, spawned) against `torch.linalg` / numpy and the JAX
`tp` on the 8-device CPU mesh, float64; the counterparts of
tests/test_tp_cholesky.py at its tolerances: the factor rtol 1e-10 /
atol 1e-10 (n = 128, block 8), solves rtol 1e-9 / atol 1e-11 (n = 64,
block 4, one and five right-hand sides), cofactor columns rtol 1e-8 /
atol 1e-12 against the dense inverse, the direct reduced solve against
PCG at tol 1e-14 rtol 1e-7 / atol 1e-9, and S v against the implicit
matvec rtol 1e-8 / atol 1e-10 (`bench.build_problem(256, 16, 6, seed=5)`,
damping 1e-4).  The assembled reduced system against the JAX
`tp.assemble_reduced_system` within 1e-9 of its largest entry; the rhs
rtol 1e-9.  Every rank holds the same bits of every replicated result.
"""

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch import convert, synthetic
from bundle_adjustment_tpu_torch.parallel import engine, multihost, rcs, tp

RANKS = (1, 2)
TIMEOUT = 120
DAMPING = 1e-4


def _spd(seed, n):
    A = np.random.default_rng(seed).standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def _reduced_problem():
    ph, sh, spec = synthetic.build_problem(256, 16, 6, seed=5)
    p = engine.fm_problem(convert.problem_to_torch(ph, "cpu", torch.float64))
    st = convert.state_to_torch(sh, "cpu", torch.float64)
    return p, engine.prepare(p, st, spec, DAMPING, couple_global=True)


def _worker(comm):
    t = torch.as_tensor
    out = {}
    S = t(_spd(7, 128))
    L = tp.distributed_cholesky(S, comm, block=8)
    out["L"] = tp.gather_factor(L, comm)
    S2 = t(_spd(8, 64))
    r = t(np.random.default_rng(8).standard_normal(64))
    L2 = tp.distributed_cholesky(S2, comm, block=4)
    out["x"] = tp.distributed_cholesky_solve(L2, r, comm)
    S3 = t(_spd(9, 64))
    R = t(np.random.default_rng(9).standard_normal((64, 5)))
    L3 = tp.distributed_cholesky(S3, comm, block=4)
    out["X"] = tp.distributed_cholesky_solve(L3, R, comm)
    out["Q"] = tp.reduced_cofactor_columns(L3, [0, 17, 63], 64, comm)
    for bad in ([64], [-1]):
        try:
            tp.reduced_cofactor_columns(L3, bad, 64, comm)
        except ValueError as exc:
            out.setdefault("index_errors", []).append(str(exc))
    try:
        tp.distributed_cholesky(torch.eye(60, dtype=torch.float64), comm, 8)
    except ValueError as exc:
        out["dim_error"] = str(exc)
    p, (b, _rc, _rg, _M) = _reduced_problem()
    out["xc"], out["xg"] = tp.solve_reduced_direct(p, b, comm, block=8)
    out["S"], out["r"] = tp.assemble_reduced_system(p, b)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {D: multihost.run_ranks(
        _worker, D, device="cpu", timeout=TIMEOUT,
        workdir=tmp_path_factory.mktemp(f"tp{D}")) for D in RANKS}


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import bench as B
    from bundle_adjustment_tpu.parallel import rcs as R
    from bundle_adjustment_tpu.parallel import tp as J

    mesh = Mesh(np.array(jax.devices()[:8]), (J.AXIS,))
    out = {"L": np.asarray(J.distributed_cholesky(
        jnp.asarray(_spd(7, 128)), mesh, block=8))}
    problem, state, spec = B.build_problem(256, 16, 6, jnp.float64, seed=5)
    b = R.linearize(problem, state, spec, jnp.asarray(DAMPING, jnp.float64))
    S, r = J.assemble_reduced_system(problem, b)
    out["S"], out["r"] = np.asarray(S), np.asarray(r)
    return out


@pytest.mark.parametrize("D", RANKS)
def test_distributed_cholesky_matches_dense(ranks, jax_side, D):
    ref = np.linalg.cholesky(_spd(7, 128))
    for res in ranks[D]:
        np.testing.assert_allclose(res["L"].numpy(), ref, rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(res["L"].numpy(), jax_side["L"],
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("D", RANKS)
def test_distributed_solves_match_dense(ranks, D):
    r = np.random.default_rng(8).standard_normal(64)
    R = np.random.default_rng(9).standard_normal((64, 5))
    x_ref = np.linalg.solve(_spd(8, 64), r)
    X_ref = np.linalg.solve(_spd(9, 64), R)
    for res in ranks[D]:
        np.testing.assert_allclose(res["x"].numpy(), x_ref, rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(res["X"].numpy(), X_ref, rtol=1e-9,
                                   atol=1e-11)
        assert torch.equal(res["X"], ranks[D][0]["X"])


@pytest.mark.parametrize("D", RANKS)
def test_cofactor_columns_and_index_checks(ranks, D):
    Qref = np.linalg.inv(_spd(9, 64))[:, [0, 17, 63]]
    for res in ranks[D]:
        np.testing.assert_allclose(res["Q"].numpy(), Qref, rtol=1e-8,
                                   atol=1e-12)
        assert len(res["index_errors"]) == 2
        assert all("[0, 64)" in e for e in res["index_errors"])
        assert "multiple" in res["dim_error"]


@pytest.mark.parametrize("D", RANKS)
def test_reduced_direct_solve_matches_pcg(ranks, D):
    p, (b, rc, rg, Minv) = _reduced_problem()
    xc_ref, xg_ref, _ = rcs.pcg(
        rc, rg, Minv, lambda c, g: engine.schur_matvec(p, b, c, g),
        tol=1e-14, maxiter=2000)
    res = ranks[D][0]
    np.testing.assert_allclose(res["xc"].numpy(), xc_ref.numpy(), rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(res["xg"].numpy(), xg_ref.numpy(), rtol=1e-7,
                               atol=1e-9)
    # the explicit matrix agrees with the implicit matvec
    M = p.num_images
    v = torch.cat([res["xc"].reshape(-1), res["xg"]])
    Sv = res["S"] @ v
    mc, mg = engine.schur_matvec(p, b, res["xc"], res["xg"])
    np.testing.assert_allclose(Sv[:6 * M].numpy(), mc.reshape(-1).numpy(),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(Sv[6 * M:].numpy(), mg.numpy(), rtol=1e-8,
                               atol=1e-10)
    for other in ranks[D][1:]:
        assert torch.equal(other["S"], res["S"])
        assert torch.equal(other["xc"], res["xc"])


def test_assembled_system_matches_jax(ranks, jax_side):
    S, r = ranks[1][0]["S"].numpy(), ranks[1][0]["r"].numpy()
    Sj = jax_side["S"]
    np.testing.assert_allclose(S, Sj, rtol=0, atol=1e-9 * np.abs(Sj).max())
    np.testing.assert_allclose(r, jax_side["r"], rtol=1e-9,
                               atol=1e-12 * np.abs(jax_side["r"]).max())


def test_pad_spd_is_an_identity_border():
    S = torch.as_tensor(_spd(3, 6))
    r = torch.arange(6, dtype=torch.float64)
    Sp, rp = tp.pad_spd(S, r, 8)
    assert torch.equal(Sp[:6, :6], S) and torch.equal(Sp[6:, 6:],
                                                      torch.eye(2).double())
    assert not Sp[6:, :6].any() and torch.equal(rp[:6], r) and \
        not rp[6:].any()
