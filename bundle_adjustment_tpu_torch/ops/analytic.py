"""Closed-form image-point Jacobians (analytic fast path; port of
`bundle_adjustment_tpu/ops/analytic.py`).

Alternative to forward-mode AD (`ops/residuals.image_point_jacobian`)
for every distortion kind the reference has: the reference's chain rule
(survey E1, E6-E10) evaluated directly, one forward pass plus the closed
forms instead of one forward pass per tangent.

Zernike X/Y/Gradient partials come from `ops.distortion.zernike_contribution`
(two jvp passes over the exact forward deltas, equal to the reference chain
rule, ZernikeDistortionModelFactory.java:41-228); the AD path remains the
independent oracle.
"""

from __future__ import annotations

import torch

from ..models.distortion import DistortionSpec, DistortionType
from .collinearity import analytic_partials
from .distortion import zernike_contribution

_SUPPORTED = {
    DistortionType.AFFINITY_AND_SHEAR,
    DistortionType.TANGENTIAL_DISTORTION,
    DistortionType.RADIAL_DISTORTION,
    DistortionType.DISTANCE_DISTORTION,
    DistortionType.ZERNIKE_X,
    DistortionType.ZERNIKE_Y,
    DistortionType.ZERNIKE_GRADIENT,
}


def supports_spec(spec: DistortionSpec) -> bool:
    return all(s.kind in _SUPPORTED for s in spec.slots)


def analytic_image_jacobian_and_residual(local, obs_xy, spec: DistortionSpec,
                                         r0):
    """Returns (J [..., 2, 12+K], w [..., 2]): the A-matrix rows and
    misclosures of a batch of image observations, closed form.

    ``local`` [..., 12+K] layout matches ops/residuals: [X Y Z, x0 y0 c,
    X0 Y0 Z0 omega phi kappa, coeffs]; ``r0`` [...].
    """
    point = local[..., 0:3]
    io = local[..., 3:6]
    eo = local[..., 6:12]
    coeffs = [local[..., 12 + i] for i in range(spec.num_coefficients)]
    K = spec.num_coefficients

    proj, cp = analytic_partials(point, eo, io)
    xs, ys, Ndn = proj.xs, proj.ys, proj.N

    # d(xs,ys)/d(param): the collinearity rows without the direct principal
    # point entries (xs does not depend on x0/y0)
    zero = torch.zeros_like(xs)
    keep = torch.ones(12, dtype=local.dtype, device=local.device)
    keep[3:5] = 0.0
    dxs = cp.xs * keep
    dys = cp.ys * keep

    # denominator partials for the distance-dependent model
    # (RadialDistanceDistortionModelFactory.java:83-95): N = r13 dX + ...
    R, d = proj.R, proj.dX
    ck = torch.cos(eo[..., 5])
    sk = torch.sin(eo[..., 5])
    dN = torch.stack([
        R[..., 0, 2], R[..., 1, 2], R[..., 2, 2],  # X, Y, Z
        zero, zero, zero,  # x0, y0, c
        -R[..., 0, 2], -R[..., 1, 2], -R[..., 2, 2],  # X0, Y0, Z0
        -R[..., 2, 2] * d[..., 1] + R[..., 1, 2] * d[..., 2],  # omega
        proj.kx * ck - proj.ky * sk,  # phi
        zero,  # kappa
    ], dim=-1)

    r2 = xs * xs + ys * ys
    r02 = r0 * r0
    xxs2 = 2.0 * xs * xs
    yys2 = 2.0 * ys * ys
    xys2 = 2.0 * xs * ys

    # accumulated distortion value and its partials w.r.t. xs/ys (and N)
    deltaX = deltaY = zero
    dX_dxs = dX_dys = dY_dxs = dY_dys = zero
    dX_dN = dY_dN = zero
    coeff_rows_x = []
    coeff_rows_y = []

    zc = zernike_contribution(xs, ys, coeffs, spec, r0)
    if zc is not None:
        deltaX = deltaX + zc.deltaX
        deltaY = deltaY + zc.deltaY
        dX_dxs = dX_dxs + zc.dX_dxs
        dX_dys = dX_dys + zc.dX_dys
        dY_dxs = dY_dxs + zc.dY_dxs
        dY_dys = dY_dys + zc.dY_dys

    # tangential base term handled jointly with its higher orders
    tang = [(i, s) for i, s in enumerate(spec.slots)
            if s.kind == DistortionType.TANGENTIAL_DISTORTION]
    if tang:
        bx = coeffs[spec.slot_index(DistortionType.TANGENTIAL_DISTORTION, -1)]
        by = coeffs[spec.slot_index(DistortionType.TANGENTIAL_DISTORTION, -2)]
        base_x = bx * (r2 + xxs2) + by * xys2
        base_y = by * (r2 + yys2) + bx * xys2
        dbase_x_dxs = 2.0 * (3.0 * bx * xs + by * ys)
        dbase_x_dys = 2.0 * (by * xs + bx * ys)
        dbase_y_dxs = 2.0 * (by * xs + bx * ys)
        dbase_y_dys = 2.0 * (bx * xs + 3.0 * by * ys)
        ssum = torch.ones_like(xs)
        for i, s in tang:
            if s.key <= 0:
                continue
            ssum = ssum + coeffs[i] * r2**s.order

    for i, slot in enumerate(spec.slots):
        k = slot.kind
        ci = coeffs[i]
        if k == DistortionType.AFFINITY_AND_SHEAR:
            if slot.key == 0:  # Cx
                deltaX = deltaX + ci * xs
                dX_dxs = dX_dxs + ci
                coeff_rows_x.append(xs)
                coeff_rows_y.append(zero)
            else:  # Cy
                deltaX = deltaX + ci * ys
                dX_dys = dX_dys + ci
                coeff_rows_x.append(ys)
                coeff_rows_y.append(zero)
        elif k == DistortionType.RADIAL_DISTORTION:
            dri = r2**slot.order - r02**slot.order
            dradi = ci * dri
            deltaX = deltaX + xs * dradi
            deltaY = deltaY + ys * dradi
            const = ci * slot.order * r2 ** (slot.order - 1)
            dX_dxs = dX_dxs + xxs2 * const + dradi
            dX_dys = dX_dys + xys2 * const
            dY_dxs = dY_dxs + xys2 * const
            dY_dys = dY_dys + yys2 * const + dradi
            coeff_rows_x.append(xs * dri)
            coeff_rows_y.append(ys * dri)
        elif k == DistortionType.DISTANCE_DISTORTION:
            dri = r2**slot.order - r02**slot.order
            ddisti = ci * dri / Ndn
            deltaX = deltaX + xs * ddisti
            deltaY = deltaY + ys * ddisti
            const = (ci * slot.order * r2 ** (slot.order - 1)) / Ndn
            dX_dxs = dX_dxs + xxs2 * const + ddisti
            dX_dys = dX_dys + xys2 * const
            dY_dxs = dY_dxs + xys2 * const
            dY_dys = dY_dys + yys2 * const + ddisti
            dX_dN = dX_dN - xs * ddisti / Ndn
            dY_dN = dY_dN - ys * ddisti / Ndn
            coeff_rows_x.append(xs * dri / Ndn)
            coeff_rows_y.append(ys * dri / Ndn)
        elif k == DistortionType.TANGENTIAL_DISTORTION:
            if slot.key == -1:  # Bx column
                coeff_rows_x.append(ssum * (r2 + xxs2))
                coeff_rows_y.append(ssum * xys2)
            elif slot.key == -2:  # By column
                coeff_rows_x.append(ssum * xys2)
                coeff_rows_y.append(ssum * (r2 + yys2))
            else:  # higher-order B_i column
                ri = r2**slot.order
                coeff_rows_x.append(base_x * ri)
                coeff_rows_y.append(base_y * ri)
        elif zc is not None and i in zc.rows:
            rx, ry = zc.rows[i]
            coeff_rows_x.append(rx)
            coeff_rows_y.append(ry)
        else:  # pragma: no cover - guarded by supports_spec
            raise NotImplementedError(k)

    if tang:
        deltaX = deltaX + base_x * ssum
        deltaY = deltaY + base_y * ssum
        # d(base * sum)/dxs = sum * dbase_dxs + base * dsum_dxs
        dsum_dxs = dsum_dys = zero
        for i, s in tang:
            if s.key <= 0:
                continue
            const = 2.0 * coeffs[i] * s.order * r2 ** (s.order - 1)
            dsum_dxs = dsum_dxs + xs * const
            dsum_dys = dsum_dys + ys * const
        dX_dxs = dX_dxs + ssum * dbase_x_dxs + base_x * dsum_dxs
        dX_dys = dX_dys + ssum * dbase_x_dys + base_x * dsum_dys
        dY_dxs = dY_dxs + ssum * dbase_y_dxs + base_y * dsum_dxs
        dY_dys = dY_dys + ssum * dbase_y_dys + base_y * dsum_dys

    # core rows (include the x0/y0 identity entries) + chain rule
    def col(a):
        return a[..., None]

    row_x = cp.xs + col(dX_dxs) * dxs + col(dX_dys) * dys + col(dX_dN) * dN
    row_y = cp.ys + col(dY_dxs) * dxs + col(dY_dys) * dys + col(dY_dN) * dN

    if K:
        row_x = torch.cat([row_x, torch.stack(coeff_rows_x, dim=-1)], dim=-1)
        row_y = torch.cat([row_y, torch.stack(coeff_rows_y, dim=-1)], dim=-1)
    J = torch.stack([row_x, row_y], dim=-2)

    pred = torch.stack([io[..., 0] + xs + deltaX, io[..., 1] + ys + deltaY],
                       dim=-1)
    return J, obs_xy - pred
