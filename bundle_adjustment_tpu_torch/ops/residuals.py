"""Observation forward models, misclosures, weights and local Jacobians
(port of `bundle_adjustment_tpu/ops/residuals.py`).

The observation kinds of the reference (derivation/PartialDerivativeFactory
.java:199-473):

* image coordinates — 2 rows, collinearity + distortion, optionally
  xy-correlated 2x2 weight;
* scale bars — 1 row, spatial distance between two object points;
* directly observed parameters — identity rows, diagonal or fully populated
  weight.

Local parameter layout per image observation (length L = 12 + K):
    [X, Y, Z, x0, y0, c, X0, Y0, Z0, omega, phi, kappa, coeffs[0..K-1]]
matching the order of the closed-form partials in ops/collinearity.py with
distortion coefficients appended.  Every function is batched over leading
axes ([..., L] -> [..., 2]).

The AD Jacobian is forward-mode autodiff of :func:`predict_image_point`
over that vector (`torch.func.jacfwd`, vmapped over the observations):
term-for-term identical to the reference's analytic chain rule (see
ops/distortion.py docstring).
"""

from __future__ import annotations

import torch

from ..models.distortion import DistortionSpec
from .collinearity import project
from .distortion import distortion_delta

#: number of non-distortion local parameters (3 point + 3 io + 6 eo)
NUM_CORE_LOCAL = 12


def predict_image_point(local, spec: DistortionSpec, r0):
    """Predicted image coordinates [..., 2].

    ``local``: [..., 12 + K] local parameter vectors (see module docstring);
    x = x0 + xs + dx, y = y0 + ys + dy (PartialDerivativeFactory.java:151-152
    plus the additive distortion application in DistortionModelFactory.java).
    """
    point = local[..., 0:3]
    io = local[..., 3:6]
    eo = local[..., 6:12]
    coeffs = local[..., 12:]
    p = project(point, eo, io)
    ddx, ddy = distortion_delta(p.xs, p.ys, p.N, coeffs, spec, r0)
    x = io[..., 0] + p.xs + ddx
    y = io[..., 1] + p.ys + ddy
    return torch.stack([x, y], dim=-1)


def image_point_jacobian(local, spec: DistortionSpec, r0):
    """A-matrix rows [B, 2, L] = d(predicted)/d(local) of a batch ``local``
    [B, L] with radii ``r0`` [B], by forward-mode AD."""
    jac = torch.func.jacfwd(lambda loc, r: predict_image_point(loc, spec, r))
    return torch.func.vmap(jac)(local, r0)


def image_point_residual(local, obs_xy, spec: DistortionSpec, r0):
    """Misclosure w = observed - predicted [..., 2]."""
    return obs_xy - predict_image_point(local, spec, r0)


def image_weight_2x2(var_x, var_y, rho, sigma2_apriori):
    """2x2 weights P = sigma0^2 * Sigma^{-1} [..., 2, 2] of image points,
    analytic inverse for correlated x/y (PartialDerivativeFactory.java:300-319)."""
    inv_det = sigma2_apriori / ((1.0 - rho * rho) * var_x * var_y)
    pxx = inv_det * var_y
    pyy = inv_det * var_x
    pxy = -inv_det * rho * torch.sqrt(var_x * var_y)
    return torch.stack([torch.stack([pxx, pxy], dim=-1),
                        torch.stack([pxy, pyy], dim=-1)], dim=-2)


def scale_bar_residual_jacobian(point_a, point_b, length_obs):
    """Scale bar: w = s_obs - |B - A|; Jacobian rows on (A, B) are the unit
    vector with signs -/+ (PartialDerivativeFactory.java:210-283).

    Returns (w [...], jac_a [..., 3], jac_b [..., 3])."""
    d = point_b - point_a
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    unit = d / dist[..., None]
    return length_obs - dist, -unit, unit
