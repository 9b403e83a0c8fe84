"""Zernike distortion slots through the port's feature-major engine, against
the JAX feature-major engine, float64 on the CPU (the cases of
tests/test_engine_fm.py:228-315).

Problem: `bench.build_problem(256, 16, 8, seed=7)` with Zernike-gradient
fringes 4 and 12 and a Zernike-X fringe 5 beside radial + tangential +
affinity (G = 13), converted once for each side.  Tolerances are those of
tests/test_engine_fm.py: Jacobian rows rtol 1e-11, misclosures 1e-12; the
LM step rtol 1e-5 (PCG to 1e-12 in two frameworks), Omega 1e-8.  The
kernels' plain versions (K1 `schur_matvec_plain`, K2
`prepare_reduction_plain`) carry the Zernike global rows: their f32 outputs
within a scaled 2e-4 of the f64 engine (the kernels' tolerance).  The
end-to-end calibration (c and the radial model held, fringes 12, 24, X5)
converges with Omega at the noise level, and to the JAX solve's Omega.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.models.distortion import DistortionType as DT
from bundle_adjustment_tpu.parallel import engine as E
from bundle_adjustment_tpu.parallel import solver as JS
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.parallel import engine as TE
from bundle_adjustment_tpu_torch.parallel import kernels as TK
from bundle_adjustment_tpu_torch.parallel import solver
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def np_(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _problem(zernike):
    import bench as B

    pj, sj, spec = B.build_problem(256, 16, 8, jnp.float64, seed=7,
                                   zernike=zernike)
    pt = convert.problem_to_torch(pj, CPU, torch.float64)
    st = convert.state_to_torch(sj, CPU, torch.float64)
    return pj, sj, pt, st, spec


@pytest.fixture(scope="module")
def zproblem():
    return _problem(((DT.ZERNIKE_GRADIENT, 4), (DT.ZERNIKE_GRADIENT, 12),
                     (DT.ZERNIKE_X, 5)))


def test_zernike_linearize_matches_jax(zproblem):
    pj, sj, pt, st, spec = zproblem
    assert any(z is not None for z in spec.zernike)
    bj = E.linearize(E.fm_problem(pj), sj, spec, jnp.asarray(1e-3))
    bt = TE.linearize(TE.fm_problem(pt), st, spec, 1e-3)
    G = len(bt.Jg) // 2
    assert G == 3 + spec.num_coefficients == 13
    for name in ("Jg", "PJg", "Jp", "Jc"):
        for a, b in zip(getattr(bj, name), getattr(bt, name)):
            np.testing.assert_allclose(np_(b), np_(a), rtol=1e-11,
                                       atol=1e-14 * np.abs(np_(a)).max())
    for a, b in zip(bj.w, bt.w):
        np.testing.assert_allclose(np_(b), np_(a), rtol=1e-12)
    np.testing.assert_allclose(float(bt.omega0), float(bj.omega0),
                               rtol=1e-10)


def test_zernike_lm_step_matches_jax(zproblem):
    pj, sj, pt, st, spec = zproblem
    fj = E.fm_problem(pj)
    dj = E.lm_step(fj, sj, spec, jnp.asarray(1e-4), cg_tol=1e-12,
                   cg_maxiter=800)
    ft = TE.fm_problem(pt)
    dt = TE.lm_step(ft, st, spec, 1e-4, cg_tol=1e-12, cg_maxiter=800)
    for a, b in zip(dj[:3], dt[:3]):
        np.testing.assert_allclose(np_(b), np_(a), rtol=1e-5, atol=1e-9)
    om_j = float(E.omega_at(fj, dj[3], *dj[:3]))
    om_t = float(TE.omega_at(ft, dt[3], *dt[:3]))
    np.testing.assert_allclose(om_t, om_j, rtol=1e-8)


def _scaled(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _f32(nt):
    """A NamedTuple with its float64 tensors (also inside tuples) in f32."""
    def cast(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float64:
            return x.float()
        if isinstance(x, tuple):
            return tuple(cast(r) for r in x)
        return x

    return type(nt)(*(cast(x) for x in nt))


def test_zernike_rows_through_the_kernels_plain_versions(zproblem):
    """K1's and K2's plain versions take the Zernike global rows (G = 13 <=
    MAX_G) like any other: f32 packed rows against the f64 engine."""
    _, _, pt, st, spec = zproblem
    fv = TE.to_view_major(TE.fm_problem(pt), TK.choose_pb(256, 8, 13))
    b = TE.linearize(fv, st, spec, 1e-3)
    b32, fv32 = _f32(b), _f32(fv)
    pp = TK.pack_fm(b32, fv32, with_pw=True)
    assert pp.g == 13
    red, rg_corr, T2, T3 = TK.prepare_reduction_plain(pp)
    b64, rc, rg, _ = TE.reduce_blocks(fv, b, st, 1e-3)
    ref = TE.prepare(fv, st, spec, 1e-3)
    assert _scaled(rc, ref[1]) < 1e-12  # reduce_blocks is prepare's tail
    fin = TE.finish_reduction(fv32, b32, _f32(st), 1e-3, red, rg_corr, T2,
                              T3, True)
    assert _scaled(fin[1].double(), rc) < 2e-4
    assert _scaled(fin[2].double(), rg) < 2e-4
    rng = np.random.default_rng(1)
    xc = torch.as_tensor(rng.normal(size=rc.shape))
    xg = torch.as_tensor(rng.normal(size=rg.shape))
    oc, og = TK.schur_matvec_plain(pp, fin[0].extra_c, fin[0].extra_g,
                                   xc.float(), xg.float())
    oc_ref, og_ref = TE.schur_matvec(fv, b64, xc, xg)
    assert _scaled(oc.double(), oc_ref) < 2e-4
    assert _scaled(og.double(), og_ref) < 2e-4


def test_zernike_solver_convergence():
    """ExampleDistortionModel.java:72-87: c and the polynomial radial model
    held fixed (the m = 0 gradients span the radial + scale basis)."""
    pj, sj, pt, st, spec = _problem(((DT.ZERNIKE_GRADIENT, 12),
                                     (DT.ZERNIKE_GRADIENT, 24),
                                     (DT.ZERNIKE_X, 5)))
    fg = np.asarray(pj.free_global).copy()
    fg[2] = 0.0  # c
    for o in (1, 2, 3):
        fg[3 + spec.slot_index(DT.RADIAL_DISTORTION, o)] = 0.0
    pj = pj._replace(free_global=jnp.asarray(fg))
    pt = pt._replace(free_global=torch.as_tensor(fg))
    kw = dict(damping=1e-2, max_iterations=20, cg_tol=1e-11, cg_maxiter=1000)
    res = solver.solve(pt, st, spec, **kw)
    assert res.converged and res.max_abs_dx < 1e-8
    n_rows = 2 * pj.obs_point.shape[0]
    u = int(np.sum(np.asarray(pj.free_point))
            + np.sum(np.asarray(pj.free_eo)) + np.sum(fg))
    expected = (n_rows - u) * (5e-4) ** 2
    assert abs(res.omega / expected - 1.0) < 0.2
    res_j = JS.solve(pj, sj, spec, **kw)
    assert res_j.converged
    np.testing.assert_allclose(res.omega, res_j.omega, rtol=1e-8)
