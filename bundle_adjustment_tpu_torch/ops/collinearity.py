"""Collinearity equations: projection and closed-form partials (port of
`bundle_adjustment_tpu/ops/collinearity.py`).

Re-derivation of the reference's CollinearityEquationFactory
(`derivation/PartialDerivativeFactory.java:58-195`).  Every function is
batched over the leading axes: ``point`` [..., 3], ``eo`` [..., 6],
``io`` [..., 3] give [...] outputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rotation import rotation_wpk


class Projection(NamedTuple):
    xs: torch.Tensor  # projected image x (before principal point / distortion)
    ys: torch.Tensor
    N: torch.Tensor  # collinearity denominator (distance along optical axis)
    kx: torch.Tensor
    ky: torch.Tensor
    R: torch.Tensor  # [..., 3, 3] rotation
    dX: torch.Tensor  # [..., 3] object - camera position


def project(point, eo, io) -> Projection:
    """Project object points into the (undistorted) image plane.

    xs = -c * kx / N, ys = -c * ky / N with
    kx = r11 dX + r21 dY + r31 dZ, ky = r12 dX + ..., N = r13 dX + ...
    (PartialDerivativeFactory.java:141-149).
    """
    c = io[..., 2]
    R = rotation_wpk(eo[..., 3], eo[..., 4], eo[..., 5])
    d = point - eo[..., :3]
    kx = R[..., 0, 0] * d[..., 0] + R[..., 1, 0] * d[..., 1] \
        + R[..., 2, 0] * d[..., 2]
    ky = R[..., 0, 1] * d[..., 0] + R[..., 1, 1] * d[..., 1] \
        + R[..., 2, 1] * d[..., 2]
    N = R[..., 0, 2] * d[..., 0] + R[..., 1, 2] * d[..., 1] \
        + R[..., 2, 2] * d[..., 2]
    xs = -c * kx / N
    ys = -c * ky / N
    return Projection(xs=xs, ys=ys, N=N, kx=kx, ky=ky, R=R, dX=d)


class CollinearityPartials(NamedTuple):
    """All 24 closed-form partials of (xs, ys) w.r.t.
    (X, Y, Z, x0, y0, c, X0, Y0, Z0, omega, phi, kappa)
    (PartialDerivativeFactory.java:155-189)."""

    xs: torch.Tensor  # [..., 12]
    ys: torch.Tensor  # [..., 12]


def analytic_partials(point, eo, io) -> tuple[Projection, CollinearityPartials]:
    p = project(point, eo, io)
    c = io[..., 2]
    R, d, N = p.R, p.dX, p.N
    ck = torch.cos(eo[..., 5])
    sk = torch.sin(eo[..., 5])

    def r(i, j):
        return R[..., i, j]

    # x-equation
    par_xs_X = -(r(0, 2) * p.xs + c * r(0, 0)) / N
    par_xs_Y = -(r(1, 2) * p.xs + c * r(1, 0)) / N
    par_xs_Z = -(r(2, 2) * p.xs + c * r(2, 0)) / N
    par_xs_x0 = torch.ones_like(N)
    par_xs_y0 = torch.zeros_like(N)
    par_xs_c = -p.kx / N
    par_xs_omega = (p.xs * (r(2, 2) * d[..., 1] - r(1, 2) * d[..., 2])
                    + c * (r(2, 0) * d[..., 1] - r(1, 0) * d[..., 2])) / N
    par_xs_phi = (p.xs * (p.ky * sk - p.kx * ck) + c * N * ck) / N
    par_xs_kappa = p.ys

    # y-equation
    par_ys_X = -(r(0, 2) * p.ys + c * r(0, 1)) / N
    par_ys_Y = -(r(1, 2) * p.ys + c * r(1, 1)) / N
    par_ys_Z = -(r(2, 2) * p.ys + c * r(2, 1)) / N
    par_ys_x0 = torch.zeros_like(N)
    par_ys_y0 = torch.ones_like(N)
    par_ys_c = -p.ky / N
    par_ys_omega = (p.ys * (r(2, 2) * d[..., 1] - r(1, 2) * d[..., 2])
                    + c * (r(2, 1) * d[..., 1] - r(1, 1) * d[..., 2])) / N
    par_ys_phi = (p.ys * (p.ky * sk - p.kx * ck) - c * N * sk) / N
    par_ys_kappa = -p.xs

    xs_row = torch.stack(
        [par_xs_X, par_xs_Y, par_xs_Z, par_xs_x0, par_xs_y0, par_xs_c,
         -par_xs_X, -par_xs_Y, -par_xs_Z, par_xs_omega, par_xs_phi,
         par_xs_kappa], dim=-1)
    ys_row = torch.stack(
        [par_ys_X, par_ys_Y, par_ys_Z, par_ys_x0, par_ys_y0, par_ys_c,
         -par_ys_X, -par_ys_Y, -par_ys_Z, par_ys_omega, par_ys_phi,
         par_ys_kappa], dim=-1)
    return p, CollinearityPartials(xs=xs_row, ys=ys_row)
