"""The port's free-network corrections (parallel/freenet.py) and the full
LM step around them (engine.lm_step_full / omega_at_full) against the JAX
package, on the CPU.

One `bench.build_problem` network (numpy, seeded) is re-dressed by
`synthetic.free_network` and the same host arrays go into both sides
(`convert`).  Tolerances:

* `prepare_extras`, field by field, on identical blocks (the JAX
  linearisation converted): f64 within 1e-9 of the field's largest entry;
  f32 within 2e-4 of it (the reference's f32 tolerance,
  tests/test_pallas_prepare.py:37-65).  Cases: bars only, datum only (all
  seven defects), bars + datum, a populated direct group;
* `wrap_matvec` / `wrap_precond` on seeded vectors: f64 within 1e-10, f32
  within 2e-4 of the output's largest entry; and `wrap_precond` against
  the dense inverse of M + W^T C W on a tiny problem (f64, 1e-9);
* `lm_step_full` against the JAX `engine.lm_step_full` (f64, cg_tol
  1e-12): dxp, dxc, dxg at rtol 1e-5 / atol 1e-9, `omega_at_full` at rtol
  1e-8, |B dxp| < 1e-10; on the point-major and the view-major layout and
  through the kernels' plain versions, with dummy points (200 points
  padded to 256), with diagonal dp / de / dg observations, with bars that
  share ends, and with a populated group.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from test_torch_parity import CPU, blocks_to_torch, np_
from bundle_adjustment_tpu.parallel import engine as E
from bundle_adjustment_tpu.parallel import freenet as F
from bundle_adjustment_tpu.parallel import rcs as R
from bundle_adjustment_tpu_torch import convert, synthetic
from bundle_adjustment_tpu_torch.parallel import engine as TE
from bundle_adjustment_tpu_torch.parallel import freenet, rcs
from _torch_threads import one_torch_thread  # noqa: F401

ALL_DEFECTS = (True,) * 7


def network(P, M, V, seed, f64=True, defects=None, repeat_ends=False, **kw):
    """(JAX RCSProblem, JAX state, port RCSProblem, port state, spec): a
    bench network re-dressed by `synthetic.free_network(**kw)` and padded
    to a multiple of 128 points."""
    jdt, tdt = (jnp.float64, torch.float64) if f64 \
        else (jnp.float32, torch.float32)
    problem, state, spec = bench.build_problem(P, M, V, jdt, seed=seed)
    problem = synthetic.free_network(problem, state, seed=seed + 1, **kw)
    if defects is not None:
        problem = problem._replace(defect_flags_d=defects)
    if repeat_ends:
        # three bars that share point 0, two of them as their first end
        a, b = np.array([0, 0, 5], np.int32), np.array([1, 2, 0], np.int32)
        pts = np.asarray(state.points, np.float64)
        problem = problem._replace(
            sb_a=a, sb_b=b, sb_weight=np.full(3, 1e6, problem.obs_xy.dtype),
            sb_length=(np.linalg.norm(pts[b] - pts[a], axis=1)
                       * (1 + 1e-5)).astype(problem.obs_xy.dtype))
    problem, state, _ = E.pad_problem(problem, state)
    return (problem, state, convert.problem_to_torch(problem, CPU, tdt),
            convert.state_to_torch(state, CPU, tdt), spec)


def close(t, j, tol, name=""):
    j = np.asarray(j)
    np.testing.assert_allclose(np_(t), j, rtol=0,
                               atol=tol * max(np.max(np.abs(j)), 1e-300),
                               err_msg=name)


EXTRAS_CASES = {
    "bars": dict(bars=3, datum=False),
    "datum": dict(bars=0, defects=ALL_DEFECTS),
    "bars_datum": dict(bars=3),
    "group": dict(bars=0, datum=False, direct=dict(group=9)),
}
FIELDS = ("Zc", "Zg", "Cap", "Yc", "Yg", "Bb", "z0_full", "rc", "rg",
          "omega0")


def extras_pair(name, f64):
    """(JAX Extras, port Extras, JAX and port (matvec, apply_M)) of one
    case, on identical blocks."""
    pj, sj, pt, st, spec = network(200, 12, 6, seed=5, f64=f64,
                                   **EXTRAS_CASES[name])
    fj, ft = E.fm_problem(pj), TE.fm_problem(pt)
    bj, rcj, rgj, Mj = E.prepare(fj, sj, spec, jnp.asarray(1e-4, sj.points.dtype))
    bt = blocks_to_torch(bj)
    Mt = rcs.Precond(*(None if x is None else torch.as_tensor(np.array(x))
                       for x in Mj))
    ext_j = F.prepare_extras(pj, sj, jnp.stack(bj.bp, axis=1), rcj, rgj,
                             E.point_ops(fj, bj), bj.omega0)
    ext_t = freenet.prepare_extras(
        pt, st, torch.stack(bt.bp, dim=1), torch.as_tensor(np.array(rcj)),
        torch.as_tensor(np.array(rgj)), TE.point_ops(ft, bt), bt.omega0)
    ops_j = (lambda c, g: E.schur_matvec(fj, bj, c, g), R.make_apply_M(Mj))
    ops_t = (lambda c, g: TE.schur_matvec(ft, bt, c, g), rcs.make_apply_M(Mt))
    return ext_j, ext_t, ops_j, ops_t


@pytest.fixture(scope="module", params=sorted(EXTRAS_CASES))
def extras64(request):
    return (request.param,) + extras_pair(request.param, True)


def test_prepare_extras_fields_match_jax_f64(extras64):
    name, ext_j, ext_t = extras64[:3]
    for f in FIELDS:
        a, b = getattr(ext_j, f), getattr(ext_t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.dtype == torch.float64, f
            close(b, a, 1e-9, f"{name}: {f}")
    assert (ext_t.W is None) == (ext_j.Zc is None and ext_j.Yc is None)


def test_wrapped_matvec_and_precond_match_jax_f64(extras64):
    name, ext_j, ext_t, (mv_j, M_j), (mv_t, M_t) = extras64
    rng = np.random.default_rng(2)
    xc, xg = rng.normal(size=ext_j.rc.shape), rng.normal(size=ext_j.rg.shape)
    for wrap_j, wrap_t, base_j, base_t in (
            (F.wrap_matvec, freenet.wrap_matvec, mv_j, mv_t),
            (F.wrap_precond, freenet.wrap_precond, M_j, M_t)):
        oj = wrap_j(base_j, ext_j)(jnp.asarray(xc), jnp.asarray(xg))
        ot = wrap_t(base_t, ext_t)(torch.as_tensor(xc), torch.as_tensor(xg))
        for a, b in zip(oj, ot):
            close(b, a, 1e-10, f"{name}: {wrap_t.__name__}")


@pytest.mark.parametrize("name", ["bars_datum", "group"])
def test_extras_match_jax_f32(name):
    ext_j, ext_t, (mv_j, M_j), (mv_t, M_t) = extras_pair(name, False)
    for f in FIELDS:
        a, b = getattr(ext_j, f), getattr(ext_t, f)
        if a is not None:
            assert b.dtype == torch.float32, f
            close(b, a, 2e-4, f"{name}: {f}")
    rng = np.random.default_rng(3)
    xc = rng.normal(size=ext_j.rc.shape).astype(np.float32)
    xg = rng.normal(size=ext_j.rg.shape).astype(np.float32)
    for wrap_j, wrap_t, base_j, base_t in (
            (F.wrap_matvec, freenet.wrap_matvec, mv_j, mv_t),
            (F.wrap_precond, freenet.wrap_precond, M_j, M_t)):
        oj = wrap_j(base_j, ext_j)(jnp.asarray(xc), jnp.asarray(xg))
        ot = wrap_t(base_t, ext_t)(torch.as_tensor(xc), torch.as_tensor(xg))
        for a, b in zip(oj, ot):
            close(b, a, 2e-4, f"{name}: {wrap_t.__name__}")


def test_wrap_precond_is_the_dense_inverse():
    """(M + W^T C W)^-1 applied to a vector, against the dense matrices of
    a tiny free network (4 images: 34 unknowns, d + Q = 8 rows)."""
    _, _, pt, st, spec = network(128, 4, 3, seed=9, bars=2)
    ft = TE.fm_problem(pt)
    b, rc, rg, Minv = TE.prepare(ft, st, spec, 1e-4, couple_global=True)
    ext = freenet.prepare_extras(pt, st, torch.stack(b.bp, dim=1), rc, rg,
                                 TE.point_ops(ft, b), b.omega0)
    apply_M = rcs.make_apply_M(Minv)
    k, n = rc.numel(), rc.numel() + rg.numel()
    eye = torch.eye(n, dtype=torch.float64)
    Minv_dense = torch.stack([
        torch.cat([z.reshape(-1) for z in apply_M(e[:k].reshape(rc.shape),
                                                  e[k:])]) for e in eye]).T
    assert ext.W.shape == (8, n)
    full = torch.linalg.inv(torch.linalg.inv(Minv_dense)
                            + ext.W.T @ ext.C @ ext.W)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=n))
    zc, zg = freenet.wrap_precond(apply_M, ext)(x[:k].reshape(rc.shape),
                                                x[k:])
    close(torch.cat([zc.reshape(-1), zg]), np_(full @ x), 1e-9)


STEP_CASES = {
    "bars_datum": dict(bars=3),
    "direct_diagonal": dict(bars=2, direct=dict(dp=20, de=4, dg=True)),
    "repeated_ends": dict(bars=3, repeat_ends=True),
    "group": dict(bars=2, datum=False, direct=dict(group=9)),
}
# port variants held against one JAX (point-major) step of each case
STEP_VARIANTS = [("bars_datum", "point_major"), ("bars_datum", "view_major"),
                 ("bars_datum", "kernels"), ("direct_diagonal", "view_major"),
                 ("direct_diagonal", "kernels"),
                 ("repeated_ends", "point_major"), ("repeated_ends", "kernels"),
                 ("group", "point_major"), ("group", "view_major")]


@pytest.fixture(scope="module")
def jax_steps():
    """One JAX `engine.lm_step_full` per case (f64, point-major)."""
    out = {}
    for name, kw in STEP_CASES.items():
        pj, sj, pt, st, spec = network(200, 12, 6, seed=7, **kw)
        fj = E.fm_problem(pj)
        dxp, dxc, dxg, b, _, ext = E.lm_step_full(
            fj, pj, sj, spec, jnp.asarray(1e-4), cg_tol=1e-12,
            cg_maxiter=1500)
        om = E.omega_at_full(fj, pj, b, ext, dxp, dxc, dxg, sj)
        out[name] = (pt, st, spec, np.asarray(dxp), np.asarray(dxc),
                     np.asarray(dxg), float(om), float(b.omega0))
    return out


@pytest.mark.parametrize("name,variant", STEP_VARIANTS)
def test_lm_step_full_matches_jax(jax_steps, name, variant):
    pt, st, spec, dxp_j, dxc_j, dxg_j, om_j, om0_j = jax_steps[name]
    assert pt.has_extras and pt.num_points == 256
    assert float(pt.free_point[200:].sum()) == 0.0  # the dummy points
    ft = TE.fm_problem(pt)
    if variant != "point_major":
        ft = TE.to_view_major(ft, 32)
    dxp, dxc, dxg, b, it, ext = TE.lm_step_full(
        ft, pt, st, spec, 1e-4, cg_tol=1e-12, cg_maxiter=1500,
        use_kernels=variant == "kernels")
    assert 0 < it < 1500
    np.testing.assert_allclose(np_(dxp), dxp_j, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(np_(dxc), dxc_j, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(np_(dxg), dxg_j, rtol=1e-5, atol=1e-9)
    assert float(dxp[200:].abs().max()) == 0.0
    np.testing.assert_allclose(float(b.omega0), om0_j, rtol=1e-10)
    om = TE.omega_at_full(ft, pt, b, ext, dxp, dxc, dxg, st)
    np.testing.assert_allclose(float(om), om_j, rtol=1e-8)
    if ext.Brows is not None:
        assert float(ext.Brows[:, 200:].abs().max()) == 0.0
        bdx = torch.einsum("kpa,pa->k", ext.Brows, dxp)
        assert float(bdx.abs().max()) < 1e-10


def test_lm_step_full_without_extras_is_lm_step():
    """Diagonal direct observations alone take the `lm_step` route (no
    low-rank rows) and agree with the JAX step."""
    pj, sj, pt, st, spec = network(200, 12, 6, seed=11, bars=0, datum=False,
                                   direct=dict(dp=20, de=4, dg=True))
    assert not pt.has_extras and pt.dp_w is not None
    fj, ft = E.fm_problem(pj), TE.fm_problem(pt)
    dxp_j, dxc_j, dxg_j, bj, _, ext_j = E.lm_step_full(
        fj, pj, sj, spec, jnp.asarray(1e-4), cg_tol=1e-12, cg_maxiter=1500)
    dxp, dxc, dxg, b, it, ext = TE.lm_step_full(
        ft, pt, st, spec, 1e-4, cg_tol=1e-12, cg_maxiter=1500)
    assert ext is None and ext_j is None
    np.testing.assert_allclose(np_(dxp), np.asarray(dxp_j), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(np_(dxc), np.asarray(dxc_j), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(np_(dxg), np.asarray(dxg_j), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(np_(b.extra_c), np.asarray(bj.extra_c),
                               rtol=1e-9)
    om_j = E.omega_at_full(fj, pj, bj, None, dxp_j, dxc_j, dxg_j, sj)
    om = TE.omega_at_full(ft, pt, b, None, dxp, dxc, dxg, st)
    np.testing.assert_allclose(float(om), float(om_j), rtol=1e-8)


def test_repeated_step_gives_equal_bits():
    """Bars that share ends: two runs of one f32 step give the same bits
    (the sums over rows that share a point are taken in a fixed order)."""
    _, _, pt, st, spec = network(200, 12, 6, seed=7, f64=False, bars=3,
                                 repeat_ends=True)
    ft = TE.to_view_major(TE.fm_problem(pt), 32)
    runs = [TE.lm_step_full(ft, pt, st, spec, 1e-4, cg_tol=1e-6,
                            cg_maxiter=50, use_kernels=True)[:3]
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_datum_rows_ignore_dummy_points():
    """`datum_rows_dense`: unit rows, zero on the dummy points, equal to
    the JAX rows."""
    pj, sj, pt, st, _ = network(200, 12, 6, seed=5, bars=0,
                                defects=ALL_DEFECTS)
    Bj = F.datum_rows_dense(sj.points, jnp.asarray(pj.datum_mask_d),
                            pj.defect_flags_d)
    Bt = freenet.datum_rows_dense(st.points, pt.datum_mask_d,
                                  pt.defect_flags_d)
    assert Bt.shape == (7, 256, 3)
    close(Bt, Bj, 1e-13)
    assert float(Bt[:, 200:].abs().max()) == 0.0
    close(torch.sum(Bt * Bt, dim=(1, 2)), np.ones(7), 1e-13)
    assert freenet.datum_rows_dense(st.points, pt.datum_mask_d,
                                    (False,) * 7) is None
