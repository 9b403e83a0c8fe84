"""Feature-major forward model: collinearity + distortion rows as [N] tensors.

Port of `bundle_adjustment_tpu/ops/fm.py`: the same closed forms
(PartialDerivativeFactory.java:58-195 and the distortion factories) with
every per-observation scalar held as a row of length N, producing the
Jacobian as a list of [N] feature rows.  Every distortion kind is
supported; Zernike slots take their deltas and partials from
`ops.distortion.zernike_contribution`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.distortion import DistortionSpec, DistortionType
from .distortion import zernike_contribution


class RotationRows(NamedTuple):
    r11: torch.Tensor
    r12: torch.Tensor
    r13: torch.Tensor
    r21: torch.Tensor
    r22: torch.Tensor
    r23: torch.Tensor
    r31: torch.Tensor
    r32: torch.Tensor
    r33: torch.Tensor


def rotation_rows(omega, phi, kappa) -> RotationRows:
    """R(omega, phi, kappa) entries as separate [N] rows
    (ExteriorOrientation.java:52-85)."""
    return rotation_from_trig(torch.cos(omega), torch.sin(omega),
                              torch.cos(phi), torch.sin(phi),
                              torch.cos(kappa), torch.sin(kappa))


def rotation_from_trig(co, so, cp, sp, ck, sk) -> RotationRows:
    """`rotation_rows` from the cosines and sines of the three angles
    (tensors or numpy arrays)."""
    return RotationRows(
        r11=cp * ck, r12=-cp * sk, r13=sp,
        r21=co * sk + so * sp * ck, r22=co * ck - so * sp * sk, r23=-so * cp,
        r31=so * sk - co * sp * ck, r32=so * ck + co * sp * sk, r33=co * cp,
    )


class ProjectionRows(NamedTuple):
    xs: torch.Tensor
    ys: torch.Tensor
    N: torch.Tensor
    kx: torch.Tensor
    ky: torch.Tensor
    R: RotationRows
    dX: torch.Tensor
    dY: torch.Tensor
    dZ: torch.Tensor


def project_rows(X, Y, Z, c, X0, Y0, Z0, omega, phi, kappa,
                 lo=None, R=None) -> ProjectionRows:
    """xs = -c kx / N etc. (PartialDerivativeFactory.java:141-149).

    ``lo``: optional low-order rows (Xlo, Ylo, Zlo, X0lo, Y0lo, Z0lo) of a
    two-float (hi+lo) state: dX = (Xhi - X0hi) + (Xlo - X0lo), each f32
    subtraction exactly rounded, so dX keeps ~2 eps relative error
    regardless of |X|.  ``R``: the `RotationRows` of the angles where the
    caller has them (`synthetic.predict`: per image, gathered)."""
    if R is None:
        R = rotation_rows(omega, phi, kappa)
    dX, dY, dZ = X - X0, Y - Y0, Z - Z0
    if lo is not None:
        Xlo, Ylo, Zlo, X0lo, Y0lo, Z0lo = lo
        dX = dX + (Xlo - X0lo)
        dY = dY + (Ylo - Y0lo)
        dZ = dZ + (Zlo - Z0lo)
    kx = R.r11 * dX + R.r21 * dY + R.r31 * dZ
    ky = R.r12 * dX + R.r22 * dY + R.r32 * dZ
    Ndn = R.r13 * dX + R.r23 * dY + R.r33 * dZ
    xs = -c * kx / Ndn
    ys = -c * ky / Ndn
    return ProjectionRows(xs=xs, ys=ys, N=Ndn, kx=kx, ky=ky, R=R,
                          dX=dX, dY=dY, dZ=dZ)


def jacobian_rows(X, Y, Z, x0, y0, c, X0, Y0, Z0, omega, phi, kappa,
                  coeffs, spec: DistortionSpec, r0, lo=None, R=None):
    """Full analytic A-rows and predictions, feature-major.

    ``coeffs``: list of K [N] rows.  Returns (rows_x, rows_y, pred_x,
    pred_y): rows_* are lists of 12+K [N] rows ordered
    [X Y Z x0 y0 c X0 Y0 Z0 omega phi kappa, coeffs...].  ``R``: see
    `project_rows`."""
    p = project_rows(X, Y, Z, c, X0, Y0, Z0, omega, phi, kappa, lo=lo, R=R)
    xs, ys, Ndn, R = p.xs, p.ys, p.N, p.R
    ck, sk = torch.cos(kappa), torch.sin(kappa)
    zero = torch.zeros_like(Ndn)
    one = torch.ones_like(Ndn)

    # collinearity partials (PartialDerivativeFactory.java:155-189)
    par_xs_X = -(R.r13 * xs + c * R.r11) / Ndn
    par_xs_Y = -(R.r23 * xs + c * R.r21) / Ndn
    par_xs_Z = -(R.r33 * xs + c * R.r31) / Ndn
    par_xs_c = -p.kx / Ndn
    par_xs_omega = (xs * (R.r33 * p.dY - R.r23 * p.dZ)
                    + c * (R.r31 * p.dY - R.r21 * p.dZ)) / Ndn
    par_xs_phi = (xs * (p.ky * sk - p.kx * ck) + c * Ndn * ck) / Ndn
    par_xs_kappa = ys

    par_ys_X = -(R.r13 * ys + c * R.r12) / Ndn
    par_ys_Y = -(R.r23 * ys + c * R.r22) / Ndn
    par_ys_Z = -(R.r33 * ys + c * R.r32) / Ndn
    par_ys_c = -p.ky / Ndn
    par_ys_omega = (ys * (R.r33 * p.dY - R.r23 * p.dZ)
                    + c * (R.r32 * p.dY - R.r22 * p.dZ)) / Ndn
    par_ys_phi = (ys * (p.ky * sk - p.kx * ck) - c * Ndn * sk) / Ndn
    par_ys_kappa = -xs

    cp_xs = [par_xs_X, par_xs_Y, par_xs_Z, one, zero, par_xs_c,
             -par_xs_X, -par_xs_Y, -par_xs_Z,
             par_xs_omega, par_xs_phi, par_xs_kappa]
    cp_ys = [par_ys_X, par_ys_Y, par_ys_Z, zero, one, par_ys_c,
             -par_ys_X, -par_ys_Y, -par_ys_Z,
             par_ys_omega, par_ys_phi, par_ys_kappa]
    # chain-rule carriers exclude the direct x0/y0 identity entries
    dxs = list(cp_xs)
    dys = list(cp_ys)
    dxs[3] = dxs[4] = zero
    dys[3] = dys[4] = zero

    # denominator partials for the distance model
    # (RadialDistanceDistortionModelFactory.java:83-95)
    dN = [R.r13, R.r23, R.r33, zero, zero, zero, -R.r13, -R.r23, -R.r33,
          -R.r33 * p.dY + R.r23 * p.dZ, p.kx * ck - p.ky * sk, zero]

    r2 = xs * xs + ys * ys
    r02 = r0 * r0
    xxs2 = 2.0 * xs * xs
    yys2 = 2.0 * ys * ys
    xys2 = 2.0 * xs * ys

    deltaX = zero
    deltaY = zero
    dX_dxs = zero
    dX_dys = zero
    dY_dxs = zero
    dY_dys = zero
    dX_dN = zero
    dY_dN = zero
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
        ssum = one
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
            if slot.key == -1:  # Bx
                coeff_rows_x.append(ssum * (r2 + xxs2))
                coeff_rows_y.append(ssum * xys2)
            elif slot.key == -2:  # By
                coeff_rows_x.append(ssum * xys2)
                coeff_rows_y.append(ssum * (r2 + yys2))
            else:  # higher-order B_i
                ri = r2**slot.order
                coeff_rows_x.append(base_x * ri)
                coeff_rows_y.append(base_y * ri)
        elif zc is not None and i in zc.rows:
            rx, ry = zc.rows[i]
            coeff_rows_x.append(rx)
            coeff_rows_y.append(ry)
        else:  # pragma: no cover - every kind is handled above
            raise NotImplementedError(k)

    if tang:
        deltaX = deltaX + base_x * ssum
        deltaY = deltaY + base_y * ssum
        dsum_dxs = zero
        dsum_dys = zero
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

    rows_x = [cp_xs[j] + dX_dxs * dxs[j] + dX_dys * dys[j] + dX_dN * dN[j]
              for j in range(12)] + coeff_rows_x
    rows_y = [cp_ys[j] + dY_dxs * dxs[j] + dY_dys * dys[j] + dY_dN * dN[j]
              for j in range(12)] + coeff_rows_y

    pred_x = x0 + xs + deltaX
    pred_y = y0 + ys + deltaY
    return rows_x, rows_y, pred_x, pred_y
