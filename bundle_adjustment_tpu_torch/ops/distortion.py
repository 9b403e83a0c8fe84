"""Forward distortion corrections Delta x, Delta y (port of
`bundle_adjustment_tpu/ops/distortion.py`).

Additive corrections evaluated at the *undistorted* projected point
(xs, ys) and collinearity denominator N, exactly as the reference factories
compute their delta values:

- radial-symmetric:  Dr = sum_i A_i (r^{2i} - r0^{2i}); dx = xs*Dr, dy = ys*Dr
  (`RadiallySymmetricDistortionModelFactory.java:39-91`)
- tangential (Brown/Conrady with higher-order scaling):
  dx = [Bx (r^2 + 2 xs^2) + 2 By xs ys] * (1 + sum_i B_i r^{2i}), sym. in y
  (`TangentialDistortionModelFactory.java:39-134`)
- affinity/shear:    dx = Cx xs + Cy ys; dy = 0
  (`AffinityShearDistortionModelFactory.java:37-82`)
- distance-dependent radial: like radial but / N
  (`RadialDistanceDistortionModelFactory.java:39-162`)
- Zernike X/Y/Gradient (`ZernikeDistortionModelFactory.java:41-228`), with the
  reference's *integer-division* radial exponents (p_j // 2) reproduced
  bit-true (see models/zernike.py docstring).

Every function is elementwise over tensors of any shape; ``coeffs`` is
[..., K] (slot order of the spec) in `distortion_delta`, and an indexable
sequence of per-slot values in `zernike_contribution`.  Because the
reference's Jacobian chain rule is exactly forward-mode autodiff of these
expressions, `torch.func` over this module reproduces the reference's
analytic A-matrix entries.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.distortion import DistortionSpec, DistortionType

_ZERNIKE_KINDS = (DistortionType.ZERNIKE_X, DistortionType.ZERNIKE_Y,
                  DistortionType.ZERNIKE_GRADIENT)


def distortion_delta(xs, ys, N, coeffs, spec: DistortionSpec, r0):
    """Total additive correction (dx, dy) for one camera's model stack.

    xs, ys, N : tensors from the projection
    coeffs    : [..., K] coefficient values (slot order of ``spec``)
    r0        : second zero-crossing radius of the distortion curve
    """
    r2 = xs * xs + ys * ys
    r02 = r0 * r0
    dx = torch.zeros_like(xs)
    dy = torch.zeros_like(ys)

    def c(i):
        return coeffs[..., i]

    # Pass 1: tangential base term (Bx, By) and higher-order sum, because the
    # higher-order B_i multiply the base term.
    tangential_base_x = tangential_base_y = tangential_sum = None
    for i, slot in enumerate(spec.slots):
        if slot.kind == DistortionType.TANGENTIAL_DISTORTION and slot.key == -1:
            bx = c(i)
            by = c(spec.slot_index(DistortionType.TANGENTIAL_DISTORTION, -2))
            tangential_base_x = bx * (r2 + 2.0 * xs * xs) + by * 2.0 * xs * ys
            tangential_base_y = by * (r2 + 2.0 * ys * ys) + bx * 2.0 * xs * ys
            tangential_sum = torch.ones_like(xs)

    for i, slot in enumerate(spec.slots):
        k = slot.kind
        if k == DistortionType.AFFINITY_AND_SHEAR:
            if slot.key == 0:  # Cx
                dx = dx + c(i) * xs
            else:  # Cy
                dx = dx + c(i) * ys
        elif k == DistortionType.RADIAL_DISTORTION:
            dri = r2**slot.order - r02**slot.order
            dradi = c(i) * dri
            dx = dx + xs * dradi
            dy = dy + ys * dradi
        elif k == DistortionType.DISTANCE_DISTORTION:
            dri = r2**slot.order - r02**slot.order
            ddisti = c(i) * dri / N
            dx = dx + xs * ddisti
            dy = dy + ys * ddisti
        elif k == DistortionType.TANGENTIAL_DISTORTION and slot.key > 0:
            tangential_sum = tangential_sum + c(i) * r2**slot.order
        elif k in (DistortionType.ZERNIKE_X, DistortionType.ZERNIKE_Y):
            zdx, zdy = _zernike_xy_delta(xs, ys, r2, r02, c(i),
                                         spec.zernike[i], k)
            dx = dx + zdx
            dy = dy + zdy
        elif k == DistortionType.ZERNIKE_GRADIENT:
            zdx, zdy = _zernike_gradient_delta(xs, ys, r2, r02, c(i),
                                               spec.zernike[i])
            dx = dx + zdx
            dy = dy + zdy

    if tangential_base_x is not None:
        dx = dx + tangential_base_x * tangential_sum
        dy = dy + tangential_base_y * tangential_sum

    return dx, dy


def _zernike_xy_delta(xs, ys, r2, r02, z, zp, kind):
    """Zernike X or Y model: delta on one image axis only.

    delta = z * sum_j c_j * rn2^{p_j // 2} * G(m phi)
    (ZernikeDistortionModelFactory.java:178-214; note Java integer division
    ``pj/2``: odd exponents floor)."""
    phi = torch.atan2(ys, xs)
    rn2 = r2 / r02
    m = zp.m
    # Signed-m trig exactly as the Java source: sin(m*phi) with m < 0 gives
    # delta = -z*c*sin(m*phi) = +z*c*sin(|m|*phi).
    trig = -torch.sin(m * phi) if m < 0 else torch.cos(m * phi)
    delta = torch.zeros_like(xs)
    for t in zp.terms:
        delta = delta + z * t.coeff * rn2 ** (t.p // 2) * trig
    if kind == DistortionType.ZERNIKE_X:
        return delta, torch.zeros_like(ys)
    return torch.zeros_like(xs), delta


def _zernike_gradient_delta(xs, ys, r2, r02, z, zp):
    """Zernike Gradient model: (dx, dy) = z * grad_{xs,ys} potential
    (ZernikeDistortionModelFactory.java:41-135; Java integer division in the
    exponent ``pj/2 - 1`` reproduced)."""
    phi = torch.atan2(ys, xs)
    rn2 = r2 / r02
    m = zp.m
    sinm = torch.sin(m * phi)
    cosm = torch.cos(m * phi)
    dx = torch.zeros_like(xs)
    dy = torch.zeros_like(ys)
    for t in zp.terms:
        const_c = t.coeff / r02 * rn2 ** (t.p // 2 - 1)
        if m < 0:
            cx = -t.p * xs * sinm + m * ys * cosm
            cy = -t.p * ys * sinm - m * xs * cosm
        else:
            cx = t.p * xs * cosm + m * ys * sinm
            cy = t.p * ys * cosm - m * xs * sinm
        dx = dx + z * const_c * cx
        dy = dy + z * const_c * cy
    return dx, dy


class ZernikeContribution(NamedTuple):
    """Total Zernike delta + partials (see `zernike_contribution`)."""

    deltaX: torch.Tensor
    deltaY: torch.Tensor
    dX_dxs: torch.Tensor
    dX_dys: torch.Tensor
    dY_dxs: torch.Tensor
    dY_dys: torch.Tensor
    # slot index -> (d deltaX / d z_i, d deltaY / d z_i): the unit-coefficient
    # deltas (delta is linear in its coefficient)
    rows: dict


def zernike_contribution(xs, ys, coeff_vals, spec: DistortionSpec, r0):
    """Closed-form-equivalent Zernike partial derivatives, elementwise over
    xs / ys of any shape (batched observations in the analytic path, [N]
    feature rows in the feature-major engine).

    The reference's analytic chain rule
    (ZernikeDistortionModelFactory.java:41-228) is exactly forward-mode AD of
    the forward deltas above, so d/dxs and d/dys are taken with two
    `torch.func.jvp` passes over the summed contribution; the
    per-coefficient A-columns are the unit-coefficient deltas (the models
    are linear in z).

    ``coeff_vals``: indexable per-slot coefficient values.
    Returns None when the spec has no Zernike slots.
    """
    zslots = [(i, s, spec.zernike[i]) for i, s in enumerate(spec.slots)
              if s.kind in _ZERNIKE_KINDS]
    if not zslots:
        return None
    r02 = r0 * r0

    def total(xs_, ys_):
        r2_ = xs_ * xs_ + ys_ * ys_
        dx = torch.zeros_like(xs_)
        dy = torch.zeros_like(ys_)
        for i, s, zp in zslots:
            if s.kind == DistortionType.ZERNIKE_GRADIENT:
                zdx, zdy = _zernike_gradient_delta(
                    xs_, ys_, r2_, r02, coeff_vals[i], zp)
            else:
                zdx, zdy = _zernike_xy_delta(
                    xs_, ys_, r2_, r02, coeff_vals[i], zp, s.kind)
            dx = dx + zdx
            dy = dy + zdy
        return dx, dy

    one = torch.ones_like(xs)
    zero = torch.zeros_like(xs)
    (dX, dY), (dX_dxs, dY_dxs) = torch.func.jvp(total, (xs, ys), (one, zero))
    _, (dX_dys, dY_dys) = torch.func.jvp(total, (xs, ys), (zero, one))

    r2 = xs * xs + ys * ys
    rows = {}
    for i, s, zp in zslots:
        if s.kind == DistortionType.ZERNIKE_GRADIENT:
            rows[i] = _zernike_gradient_delta(xs, ys, r2, r02, 1.0, zp)
        else:
            rows[i] = _zernike_xy_delta(xs, ys, r2, r02, 1.0, zp, s.kind)
    return ZernikeContribution(deltaX=dX, deltaY=dY, dX_dxs=dX_dxs,
                               dX_dys=dX_dys, dY_dxs=dY_dxs, dY_dys=dY_dys,
                               rows=rows)
