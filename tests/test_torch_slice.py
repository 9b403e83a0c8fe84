"""The port's LM step and LM phase against the JAX engine on the CPU.

f64: one step with cg_tol 1e-10 agrees to 1e-6 x max|dx| (both CG runs
converge to the same solution; the residual tolerance bounds the step
difference); three LM-phase steps keep the states within 1e-6 relative.
f32: exact steps are ill-posed (two f32 CG runs stall at slightly
different iterates), so the check is functional, as in
tests/test_pallas_prepare.py:84-108: the port's step must contract Omega
below 0.9 Omega0 and to within 5% of the JAX step's Omega."""

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import build_pair, np_
from bundle_adjustment_tpu.parallel import engine as E
from bundle_adjustment_tpu.parallel import rcs as R
from bundle_adjustment_tpu_torch.parallel import engine as TE
from bundle_adjustment_tpu_torch.parallel import kernels as TK
from bundle_adjustment_tpu_torch.parallel import lm


@pytest.fixture(scope="module")
def pair64():
    return build_pair(256, 12, 6, seed=21)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_step_f64_matches_jax(pair64, use_kernels):
    lam = 1e-3
    dj = E.lm_step(pair64.fj, pair64.state_j, pair64.spec, jnp.asarray(lam),
                   cg_tol=1e-10, cg_maxiter=200)
    dt = TE.lm_step(pair64.ft, pair64.state_t, pair64.spec, lam,
                    cg_tol=1e-10, cg_maxiter=200, use_kernels=use_kernels)
    for a, b in zip(dj[:3], dt[:3]):
        a = np.asarray(a)
        np.testing.assert_allclose(np_(b), a, rtol=0,
                                   atol=1e-6 * np.max(np.abs(a)))
    # padded dummy points stay put
    assert np.all(np_(dt[0])[np_(pair64.ft.free_point).sum(0) == 0] == 0.0)


def test_lm_phase_f64_matches_jax_loop(pair64):
    """Three steps of parallel/lm.py vs the same loop written with
    engine.lm_step + rcs.apply_step (damping x0.2, alpha scaling)."""
    st_t, ph = lm.run(pair64.ft, pair64.state_t, pair64.spec, damping=1e-2,
                      max_steps=3, use_kernels=True, cg_tol=1e-10,
                      cg_maxiter=200, stall_limit=None)
    st_j, lam = pair64.state_j, 1e-2
    for _ in range(3):
        dxp, dxc, dxg, _, _ = E.lm_step(pair64.fj, st_j, pair64.spec,
                                        jnp.asarray(lam), cg_tol=1e-10,
                                        cg_maxiter=200)
        a = lm.step_scale(lam)
        st_j, _ = R.apply_step(st_j, pair64.problem_j, a * dxp, a * dxc,
                               a * dxg)
        lam = 0.0 if lam < 1e-9 else lam * 0.2
    assert ph.steps == 3 and len(ph.cg_iterations) == 3
    for a0, a, b in zip(pair64.state_j, st_j, st_t):
        a, b, a0 = np.asarray(a), np_(b), np.asarray(a0)
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6 * np.max(
            np.abs(a)))
        # the moves themselves agree too (the states are dominated by x0)
        np.testing.assert_allclose(b - a0, a - a0, rtol=0, atol=1e-6 * max(
            np.max(np.abs(a - a0)), 1e-300))


def test_step_scale():
    """alpha = min(0.25 lambda^-0.05, 0.75), 1 at lambda = 0
    (BundleAdjustment.java:392-394, bench.py:621)."""
    assert lm.step_scale(1e-2) == pytest.approx(0.25 * 1e-2 ** -0.05)
    assert lm.step_scale(1e-12) == 0.75
    assert lm.step_scale(0.0) == 1.0


def test_lm_step_f32_contracts_like_jax():
    pr = build_pair(128, 6, 4, seed=13, f64=False)
    lam = 1e-4
    dxp, dxc, dxg, b, it = TE.lm_step(pr.ft, pr.state_t, pr.spec, lam,
                                      cg_tol=1e-8, cg_maxiter=200,
                                      use_kernels=True)
    om = float(TE.omega_at(pr.ft, b, dxp, dxc, dxg))
    dj = E.lm_step(pr.fj, pr.state_j, pr.spec, jnp.asarray(lam, jnp.float32),
                   cg_tol=1e-8, cg_maxiter=200)
    om_j = float(E.omega_at(pr.fj, dj[3], dj[0], dj[1], dj[2]))
    assert om < 0.9 * float(b.omega0)
    assert om < 1.05 * om_j
    assert it > 0


def test_lm_phase_f32_reaches_noise_floor():
    """The f32 phase through the kernel path (plain versions on the CPU)
    converges to Omega / dof = sigma^2 within 5% (dof ~ 2.4k here)."""
    pr = build_pair(256, 12, 6, seed=4, f64=False)
    TK.reset_launch_counts()
    st, ph = lm.run(pr.ft, pr.state_t, pr.spec)
    assert TK.launch_counts() == {"cam_gather": 0, "schur_matvec": 0,
                                  "prepare_reduction": 0}  # CPU: plain
    b = TE.linearize(pr.ft, st, pr.spec, 0.0)
    n = 2 * int((pr.ft.wxx > 0).sum())
    u = int(pr.ft.free_point.sum() + pr.ft.free_eo.sum()
            + pr.ft.free_global.sum())
    s0 = (float(b.omega0) / (n - u)) ** 0.5
    assert abs(s0 / 5e-4 - 1.0) < 0.05
    assert ph.steps <= 60 and ph.max_dx < 1e-2
