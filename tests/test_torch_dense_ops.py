"""The port's dense-path forward model (`ops/rotation`, `collinearity`,
`distortion`, `residuals`, `analytic`) against the JAX package's, float64
on the CPU.

The JAX functions take one observation and are vmapped; the port's take
the batch.  Inputs: 64 seeded observations of a target field seen from a
camera ring, every `DistortionType` alone and all of them together.
Tolerances: values rtol 1e-12 (atol 1e-12 of the largest entry: the same
formulas in another operation order), Jacobians rtol 1e-10 (forward-mode
AD and the closed forms in two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.models.distortion import DistortionSpecBuilder
from bundle_adjustment_tpu.models.distortion import DistortionType as DT
from bundle_adjustment_tpu.ops import analytic as JA
from bundle_adjustment_tpu.ops import collinearity as JC
from bundle_adjustment_tpu.ops import distortion as JD
from bundle_adjustment_tpu.ops import residuals as JR
from bundle_adjustment_tpu.ops import rotation as JRot
from bundle_adjustment_tpu.testing import look_at_wpk
from bundle_adjustment_tpu_torch.ops import analytic as TA
from bundle_adjustment_tpu_torch.ops import collinearity as TC
from bundle_adjustment_tpu_torch.ops import distortion as TD
from bundle_adjustment_tpu_torch.ops import residuals as TR
from bundle_adjustment_tpu_torch.ops import rotation as TRot
from _torch_threads import one_torch_thread  # noqa: F401

B = 64
R0 = 8.0


def close(got, ref, rtol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _spec(kind):
    b = DistortionSpecBuilder()
    if kind in (DT.AFFINITY_AND_SHEAR, "all"):
        b.add_affinity()
    if kind in (DT.TANGENTIAL_DISTORTION, "all"):
        b.add_tangential().add_tangential_order(1).add_tangential_order(2)
    if kind in (DT.RADIAL_DISTORTION, "all"):
        for o in (1, 2, 3):
            b.add_radial_order(o)
    if kind in (DT.DISTANCE_DISTORTION, "all"):
        b.add_distance_order(1).add_distance_order(2)
    if kind in (DT.ZERNIKE_X, "all"):
        b.add_zernike(DT.ZERNIKE_X, 5).add_zernike(DT.ZERNIKE_X, 8)
    if kind in (DT.ZERNIKE_Y, "all"):
        b.add_zernike(DT.ZERNIKE_Y, 7)
    if kind in (DT.ZERNIKE_GRADIENT, "all"):
        for f in (4, 12, 13):
            b.add_zernike(DT.ZERNIKE_GRADIENT, f)
    return b.build()


_SCALE = {DT.AFFINITY_AND_SHEAR: 1e-4, DT.TANGENTIAL_DISTORTION: 5e-6,
          DT.RADIAL_DISTORTION: 1e-5, DT.DISTANCE_DISTORTION: 1e-3,
          DT.ZERNIKE_X: 2e-5, DT.ZERNIKE_Y: 2e-5, DT.ZERNIKE_GRADIENT: 2e-5}
KINDS = list(DT) + ["all"]


def _coeffs(spec, rng):
    """Seeded coefficients; polynomial orders > 1 scaled by r^-2 per order
    (|r| ~ 5..30 here) so that every term stays of a similar size."""
    poly = (DT.RADIAL_DISTORTION, DT.DISTANCE_DISTORTION,
            DT.TANGENTIAL_DISTORTION)
    return np.array([_SCALE[s.kind] * rng.uniform(0.5, 1.5)
                     / (10.0 ** (2 * s.order - 2)
                        if s.kind in poly and s.order > 1 else 1.0)
                     for s in spec.slots])


@pytest.fixture(scope="module")
def obs():
    rng = np.random.default_rng(17)
    pts = rng.uniform(-40, 40, (B, 3)) * np.array([1, 1, 0.2])
    eo = np.zeros((B, 6))
    for n in range(B):
        ang = 2 * np.pi * rng.uniform()
        pos = np.array([250 * np.cos(ang), 250 * np.sin(ang),
                        120 + 80 * rng.uniform()])
        w, p, k = look_at_wpk(pos, np.zeros(3))
        eo[n] = [*pos, w, p, k + rng.integers(0, 4) * np.pi / 2]
    io = np.tile([0.02, -0.03, -30.0], (B, 1))
    xy = rng.normal(0, 5, (B, 2))
    return dict(pts=pts, eo=eo, io=io, xy=xy, rng=rng)


def _local(o, coeffs):
    return np.concatenate([o["pts"], o["io"], o["eo"],
                           np.broadcast_to(coeffs, (B, coeffs.size))], axis=1)


def t(a):
    return torch.as_tensor(np.array(a))


def test_rotation_and_euler(obs):
    w, p, k = (obs["eo"][:, 3 + i] for i in range(3))
    Rj = jax.vmap(JRot.rotation_wpk)(w, p, k)
    Rt = TRot.rotation_wpk(t(w), t(p), t(k))
    close(Rt, Rj)
    for a, b in zip(TRot.wpk_from_rotation(Rt),
                    jax.vmap(JRot.wpk_from_rotation)(Rj)):
        close(a, b)
    u, v = obs["pts"], obs["eo"][:, :3]
    close(TRot.cross(t(u), t(v)), JRot.cross(u, v))
    ang = obs["rng"].uniform(-1.2, 1.2, (3, B))
    for order in ("xyz", "xzy", "yxz", "yzx", "zxy", "zyx",
                  "xyx", "xzx", "yxy", "yzy", "zxz", "zyz"):
        Rj = JRot.sequence_rotation(tuple(jnp.asarray(a) for a in ang), order)
        Rt = TRot.sequence_rotation(tuple(t(a) for a in ang), order)
        close(Rt, Rj)
        for a, b in zip(TRot.euler_from_rotation(Rt, order),
                        JRot.euler_from_rotation(Rj, order)):
            close(a, b)


def test_projection_and_collinearity_partials(obs):
    pj, cj = jax.vmap(JC.analytic_partials)(obs["pts"], obs["eo"], obs["io"])
    pt, ct = TC.analytic_partials(t(obs["pts"]), t(obs["eo"]), t(obs["io"]))
    for f in JC.Projection._fields:
        close(getattr(pt, f), getattr(pj, f))
    close(ct.xs, cj.xs)
    close(ct.ys, cj.ys)
    pp = TC.project(t(obs["pts"]), t(obs["eo"]), t(obs["io"]))
    close(pp.xs, pj.xs)


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: getattr(k, "name", k))
def test_distortion_delta(obs, kind):
    spec = _spec(kind)
    c = _coeffs(spec, np.random.default_rng(int(getattr(kind, "value", 9))))
    p = jax.vmap(JC.project)(obs["pts"], obs["eo"], obs["io"])
    coeffs = np.broadcast_to(c, (B, c.size))
    dj = jax.vmap(lambda xs, ys, N, cc: JD.distortion_delta(
        xs, ys, N, cc, spec, R0))(p.xs, p.ys, p.N, coeffs)
    dt = TD.distortion_delta(t(p.xs), t(p.ys), t(p.N), t(coeffs), spec,
                             torch.tensor(R0, dtype=torch.float64))
    close(dt[0], dj[0])
    close(dt[1], dj[1])
    assert float(np.abs(np.stack(dj)).max()) > 0


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: getattr(k, "name", k))
def test_prediction_residual_and_jacobians(obs, kind):
    spec = _spec(kind)
    c = _coeffs(spec, np.random.default_rng(3))
    local = _local(obs, c)
    r0 = np.full(B, R0)
    pred_j = jax.vmap(lambda x: JR.predict_image_point(x, spec, R0))(local)
    close(TR.predict_image_point(t(local), spec, t(r0)), pred_j)
    res_j = jax.vmap(lambda x, y: JR.image_point_residual(x, y, spec, R0))(
        local, obs["xy"])
    close(TR.image_point_residual(t(local), t(obs["xy"]), spec, t(r0)), res_j)

    Jj = jax.vmap(lambda x: JR.image_point_jacobian(x, spec, R0))(local)
    Jt = TR.image_point_jacobian(t(local), spec, t(r0))
    close(Jt, Jj, rtol=1e-10)

    Aj, wj = jax.vmap(lambda x, y: JA.analytic_image_jacobian_and_residual(
        x, y, spec, R0))(local, obs["xy"])
    At, wt = TA.analytic_image_jacobian_and_residual(t(local), t(obs["xy"]),
                                                     spec, t(r0))
    close(At, Aj, rtol=1e-10)
    close(wt, wj)
    close(At, Jt.numpy(), rtol=1e-10)  # closed forms == AD in the port too
    assert TA.supports_spec(spec) == JA.supports_spec(spec)


def test_zernike_contribution_partials(obs):
    spec = _spec("all")
    c = _coeffs(spec, np.random.default_rng(4))
    p = jax.vmap(JC.project)(obs["pts"], obs["eo"], obs["io"])
    zj = jax.vmap(lambda xs, ys: JD.zernike_contribution(
        xs, ys, jnp.asarray(c), spec, R0))(p.xs, p.ys)
    zt = TD.zernike_contribution(t(p.xs), t(p.ys), [torch.tensor(v, dtype=torch.float64) for v in c],
                                 spec, torch.tensor(R0, dtype=torch.float64))
    for f in JD.ZernikeContribution._fields[:6]:
        close(getattr(zt, f), getattr(zj, f), rtol=1e-10)
    assert sorted(zt.rows) == sorted(zj.rows)
    for i in zt.rows:
        for a, b in zip(zt.rows[i], zj.rows[i]):
            close(a, b)
    assert TD.zernike_contribution(t(p.xs), t(p.ys), [], _spec(
        DT.RADIAL_DISTORTION), torch.tensor(R0, dtype=torch.float64)) is None


def test_weights_and_scale_bars(obs):
    rng = np.random.default_rng(5)
    vx, vy = rng.uniform(1e-8, 1e-6, B), rng.uniform(1e-8, 1e-6, B)
    rho = rng.uniform(-0.9, 0.9, B)
    Pj = jax.vmap(lambda a, b, r: JR.image_weight_2x2(a, b, r, 2.5e-7))(
        vx, vy, rho)
    close(TR.image_weight_2x2(t(vx), t(vy), t(rho), 2.5e-7), Pj)
    a, b = obs["pts"], obs["pts"][::-1] + 1.0
    L = np.linalg.norm(b - a, axis=1) + 1e-3
    for x, y in zip(TR.scale_bar_residual_jacobian(t(a), t(b), t(L)),
                    jax.vmap(JR.scale_bar_residual_jacobian)(a, b, L)):
        close(x, y)
