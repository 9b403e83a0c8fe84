"""The port's `rcs.pcg` against the JAX reference's `rcs.pcg`, and its
masked chunk against its one-iteration-at-a-time route, on the CPU.

The system: the reduced camera system of a small network
(`synthetic.build_problem(256, 8, 6)`, u = 58) linearised by the port in
f64, made dense once (S from `engine.schur_matvec` on the unit vectors),
with its block-Jacobi `Precond`; both packages run PCG on the same dense S,
the same right-hand side and the same preconditioner blocks, cast to the
case's dtype.  The cases: converged by ``tol`` in f64; stopped by the
stall window in f32; stopped by ``maxiter`` = 13 (not a multiple of
`rcs.CG_CHUNK`); a zero right-hand side (0 iterations, the zero iterate,
no NaN); an f32 run whose best iterate is not its last.  Counts equal
JAX's; iterates within 1e-9 (f64) / 1e-4 (f32) of JAX's largest entry.

The masked chunk: the same cases run in chunks of `rcs.CG_CHUNK` masked
iterations (`rcs._cg_iteration(masked=True)`, eagerly on the CPU: what
the card replays as a CUDA graph) and read the stop once per chunk; their
iterate bits and counts equal the eager route's, and the masked
iterations are CG_CHUNK x chunks - iterations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.parallel import rcs as JR
from bundle_adjustment_tpu_torch import convert, synthetic
from bundle_adjustment_tpu_torch.parallel import engine, rcs
from _torch_threads import one_torch_thread  # noqa: F401

#: case: (dtype, zero rhs, tol, maxiter, stall_limit)
CASES = {
    "tol_f64": (torch.float64, False, 1e-9, 200, None),
    "stall_f32": (torch.float32, False, 0.0, 400, None),
    "maxiter13_f64": (torch.float64, False, 0.0, 13, None),
    "zero_rhs_f64": (torch.float64, True, 1e-10, 200, None),
    "best_not_last_f32": (torch.float32, False, 0.0, 90, 1000),
}
RTOL = {torch.float64: 1e-9, torch.float32: 1e-4}


@pytest.fixture(scope="module")
def system():
    prob_h, state_h, spec = synthetic.build_problem(256, 8, 6, seed=3)
    prob = convert.problem_to_torch(prob_h, "cpu", torch.float64)
    state = convert.state_to_torch(state_h, "cpu", torch.float64)
    p = engine.fm_problem(prob)
    b, rc, rg, Minv = engine.prepare(p, state, spec, 1e-3)
    M, G = rc.shape[0], rg.shape[0]
    eye = torch.eye(6 * M + G, dtype=torch.float64)
    sc, sg = engine.schur_matvec(p, b, eye[:, :6 * M].reshape(-1, M, 6),
                                 eye[:, 6 * M:])
    S = torch.cat([sc.reshape(-1, 6 * M), sg], dim=1)
    return dict(S=(S + S.T) / 2, rc=rc, rg=rg, Minv=Minv)


def _inputs(system, name):
    dtype, zero, tol, maxiter, stall = CASES[name]
    S = system["S"].to(dtype)
    rc, rg = system["rc"].to(dtype), system["rg"].to(dtype)
    if zero:
        rc, rg = torch.zeros_like(rc), torch.zeros_like(rg)
    Minv = rcs.Precond(system["Minv"].Minv_c.to(dtype),
                       system["Minv"].Minv_g.to(dtype))
    M = rc.shape[0]

    def matvec(xc, xg):
        y = S @ torch.cat([xc.reshape(-1), xg])
        return y[:6 * M].reshape(M, 6), y[6 * M:]

    return (rc, rg, Minv, matvec), dict(tol=tol, maxiter=maxiter,
                                        stall_limit=stall)


def _jax_pcg(system, name):
    (rc, rg, Minv, _), kw = _inputs(system, name)
    S = jnp.asarray(system["S"].to(rc.dtype).numpy())
    M = rc.shape[0]

    def matvec(xc, xg):
        y = S @ jnp.concatenate([xc.reshape(-1), xg])
        return y[:6 * M].reshape(M, 6), y[6 * M:]

    jM = JR.Precond(jnp.asarray(Minv.Minv_c.numpy()),
                    jnp.asarray(Minv.Minv_g.numpy()))
    xc, xg, it = JR.pcg(None, None, jnp.asarray(rc.numpy()),
                        jnp.asarray(rg.numpy()), jM, matvec=matvec, **kw)
    return np.asarray(xc), np.asarray(xg), int(it)


def _chunked(args, kw):
    """The masked chunk route: (carry, chunks)."""
    c, k = rcs._cg_start(*args, kw["tol"], kw["maxiter"],
                         kw["stall_limit"], None)

    def chunk():
        for _ in range(rcs.CG_CHUNK):
            rcs._cg_iteration(c, k, masked=True)

    return c, rcs._cg_chunks(c, chunk)


@pytest.mark.parametrize("name", list(CASES))
def test_pcg_matches_the_reference(system, name):
    args, kw = _inputs(system, name)
    xc, xg, it = rcs.pcg(*args, **kw)
    jxc, jxg, jit = _jax_pcg(system, name)
    assert it == jit
    scale = max(np.abs(jxc).max(), np.abs(jxg).max(), 1e-300)
    tol = RTOL[args[0].dtype]
    assert np.abs(xc.numpy() - jxc).max() <= tol * scale
    assert np.abs(xg.numpy() - jxg).max() <= tol * scale
    if name == "tol_f64":
        assert 0 < it < kw["maxiter"]
    if name == "maxiter13_f64":
        assert it == 13
    if name == "zero_rhs_f64":
        assert it == 0 and not xc.any() and not xg.any()
        assert not (xc.isnan().any() or xg.isnan().any())


@pytest.mark.parametrize("name", list(CASES))
def test_masked_chunks_match_the_eager_route(system, name):
    args, kw = _inputs(system, name)
    xc, xg, it = rcs.pcg(*args, **kw)
    c, chunks = _chunked(args, kw)
    assert int(c.it) == it and bool(c.done)
    assert torch.equal(c.bxc, xc) and torch.equal(c.bxg, xg)
    masked = rcs.CG_CHUNK * chunks - it
    assert 0 <= masked < rcs.CG_CHUNK
    assert chunks == -(-it // rcs.CG_CHUNK)
    if name == "stall_f32":
        assert int(c.stall) == 8 and it < kw["maxiter"]
    if name == "best_not_last_f32":
        assert it == kw["maxiter"]
        assert not torch.equal(c.bxc, c.xc)
    if name == "zero_rhs_f64":
        assert chunks == 0 and not (c.xc.isnan().any() or c.rc.isnan().any())
