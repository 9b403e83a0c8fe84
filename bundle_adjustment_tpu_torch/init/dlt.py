"""Direct Linear Transformation (11-parameter DLT) initialisation (port of
`bundle_adjustment_tpu/init/dlt.py`).

Re-design of `dlt/DirectLinearTransformation.java` (survey G1-G4): iterative
linear DLT fit from >= 6 homologous points with world-coordinate
normalisation, optional nonlinear restrictions appended as bordered
constraint rows, and decomposition of the estimated coefficients into
physical interior/exterior orientation starting values.

The collinearity equations in rearranged-linear form
(DLTPartialDerivativeFactory.java:238-344):

    x = X b11 + Y b12 + Z b13 + b14 - x X b31 - x Y b32 - x Z b33
    y = X b21 + Y b22 + Z b23 + b24 - y X b31 - y Y b32 - y Z b33

Restriction rows (fixed principal point/distance, identical principal
distance, rotation-without-shear; :86-236) are implemented as scalar
constraint functions differentiated with `torch.func.grad` — algebraically
identical to the reference's hand-derived gradients (verified by
expansion).  The normal equations are assembled and solved in float64 on
the requested device (CUDA by default); the decomposition of the 11
coefficients runs on the host.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import DEFAULT_MAX_ITERATIONS, EPS, SQRT_EPS
from ..solver.adjustment import resolve_device


class RestrictionType(enum.Enum):
    IDENTICAL_PRINCIPLE_DISTANCE = "identical_principle_distance"
    ROTATION_WITHOUT_SHEAR = "rotation_without_shear"
    FIXED_PRINCIPLE_DISTANCE_X = "fixed_principle_distance_x"
    FIXED_PRINCIPLE_DISTANCE_Y = "fixed_principle_distance_y"
    FIXED_PRINCIPAL_POINT_X = "fixed_principal_point_x"
    FIXED_PRINCIPAL_POINT_Y = "fixed_principal_point_y"


@dataclass
class DLTResult:
    """Estimated DLT coefficients and derived physical parameters
    (cf. DLTCoefficients.java:34-84)."""

    b: np.ndarray = field(default_factory=lambda: np.zeros(11))
    converged: bool = False
    # derived IO (x0, y0, c) and EO (X0, Y0, Z0, omega, phi, kappa)
    x0: float = 0.0
    y0: float = 0.0
    c: float = 0.0
    eo: np.ndarray = field(default_factory=lambda: np.zeros(6))


# --- restriction constraint functions g(b; io) -----------------------------
# Each returns the scalar whose gradient forms the constraint row and whose
# (signed) value forms the misclosure, matching the reference rows exactly.

def _split(b):
    return b[0:4], b[4:8], b[8:11]


def _ppx(b):
    b1_, b2_, b3_ = _split(b)
    b3s = torch.dot(b3_, b3_)
    return torch.dot(b1_[:3], b3_) / b3s


def _ppy(b):
    b1_, b2_, b3_ = _split(b)
    b3s = torch.dot(b3_, b3_)
    return torch.dot(b2_[:3], b3_) / b3s


def _pdx2(b):
    b1_, _, b3_ = _split(b)
    b3s = torch.dot(b3_, b3_)
    bx = torch.dot(b1_[:3], b3_)
    return torch.dot(b1_[:3], b1_[:3]) / b3s - (bx / b3s) ** 2


def _pdy2(b):
    _, b2_, b3_ = _split(b)
    b3s = torch.dot(b3_, b3_)
    by = torch.dot(b2_[:3], b3_)
    return torch.dot(b2_[:3], b2_[:3]) / b3s - (by / b3s) ** 2


def _identical_pd(b):
    b1_, b2_, b3_ = _split(b)
    b3s = torch.dot(b3_, b3_)
    bx = torch.dot(b1_[:3], b3_)
    by = torch.dot(b2_[:3], b3_)
    return (b3s * (torch.dot(b1_[:3], b1_[:3]) - torch.dot(b2_[:3], b2_[:3]))
            - bx * bx + by * by)


def _no_shear(b):
    b1_, b2_, b3_ = _split(b)
    b3s = torch.dot(b3_, b3_)
    bx = torch.dot(b1_[:3], b3_)
    by = torch.dot(b2_[:3], b3_)
    return -(b3s * torch.dot(b1_[:3], b2_[:3]) - bx * by)


def _restriction_row(restriction: RestrictionType, b, x0, y0, c):
    """Returns (gradient_row [11] tensor, misclosure) for one restriction at
    the coefficients ``b`` [11] (setParameterRestrictions,
    DLTPartialDerivativeFactory.java:86-236)."""
    if restriction == RestrictionType.FIXED_PRINCIPAL_POINT_X:
        fn, target, sign = _ppx, x0, 1.0
    elif restriction == RestrictionType.FIXED_PRINCIPAL_POINT_Y:
        fn, target, sign = _ppy, y0, 1.0
    elif restriction == RestrictionType.FIXED_PRINCIPLE_DISTANCE_X:
        fn, target, sign = _pdx2, c * c, 1.0
    elif restriction == RestrictionType.FIXED_PRINCIPLE_DISTANCE_Y:
        fn, target, sign = _pdy2, c * c, 1.0
    elif restriction == RestrictionType.IDENTICAL_PRINCIPLE_DISTANCE:
        fn, target, sign = _identical_pd, 0.0, 1.0
    elif restriction == RestrictionType.ROTATION_WITHOUT_SHEAR:
        fn, target, sign = _no_shear, 0.0, -1.0
    else:
        raise ValueError(restriction)
    # misclosure: target - g for the fixed values, -g for the identical
    # distance, +g for the no-shear row (the reference's signs)
    w = sign * (target - float(fn(b)))
    return torch.func.grad(fn)(b), w


def _validate_restrictions(restrictions):
    """Drop IDENTICAL_PRINCIPLE_DISTANCE when both fixed-distance
    restrictions are present (DirectLinearTransformation.java:269-277)."""
    rs = list(dict.fromkeys(restrictions))
    if (RestrictionType.FIXED_PRINCIPLE_DISTANCE_X in rs
            and RestrictionType.FIXED_PRINCIPLE_DISTANCE_Y in rs
            and RestrictionType.IDENTICAL_PRINCIPLE_DISTANCE in rs):
        rs.remove(RestrictionType.IDENTICAL_PRINCIPLE_DISTANCE)
    return rs


def adjust(image, object_coordinates: dict, *restrictions,
           max_iterations: int = DEFAULT_MAX_ITERATIONS,
           device="cuda") -> DLTResult:
    """Fit the 11 DLT coefficients of one image from homologous points and
    decompose them into IO/EO starting values
    (DirectLinearTransformation.adjust, :67-169).

    ``image``: a scene-graph Image whose measured points appear in
    ``object_coordinates`` (name -> ObjectCoordinate).  The camera's IO
    fixed-flags decide whether x0/y0/c are overwritten by the decomposition.
    ``device``: where the normal equations are built and solved (float64;
    CUDA by default, raising without a card unless ``device="cpu"``).
    """
    dev = resolve_device(device)
    restrictions = _validate_restrictions(restrictions)
    camera = image.camera
    io = camera.interior_orientation

    xy, XYZ = [], []
    for ic in image:
        name = ic.object_coordinate.name
        if name in object_coordinates:
            oc = object_coordinates[name]
            xy.append((ic.x, ic.y))
            XYZ.append((oc.x.value, oc.y.value, oc.z.value))
    if len(xy) < 6:
        raise ValueError(
            f"insufficient number of homologous points ({len(xy)} vs. 6) "
            f"in image #{image.id}")
    f64 = dict(dtype=torch.float64, device=dev)
    xy = torch.as_tensor(np.asarray(xy), **f64)
    XYZ = torch.as_tensor(np.asarray(XYZ), **f64)

    # world-scale normalisation (:106)
    ssw = float(torch.sum(XYZ * XYZ))
    ssi = float(torch.sum(xy * xy))
    scale = math.sqrt(ssw / ssi) if ssi > 0 else 1.0
    XYZs = XYZ / scale

    # the linear-in-B collinearity rows (two per point) depend on the
    # observations only
    X_, Y_, Z_ = XYZs[:, 0], XYZs[:, 1], XYZs[:, 2]
    xi, yi = xy[:, 0], xy[:, 1]
    one = torch.ones_like(X_)
    zero = torch.zeros_like(X_)
    Ax = torch.stack([X_, Y_, Z_, one, zero, zero, zero, zero,
                      -xi * X_, -xi * Y_, -xi * Z_], dim=1)
    Ay = torch.stack([zero, zero, zero, zero, X_, Y_, Z_, one,
                      -yi * X_, -yi * Y_, -yi * Z_], dim=1)
    A = torch.cat([Ax, Ay], dim=0)
    obs = torch.cat([xi, yi])

    b = torch.zeros(11, **f64)
    x0 = io.x0.value
    y0 = io.y0.value
    c = io.c.value

    R = len(restrictions)
    size = 11 + R
    converged = True
    include_restrictions = False
    runs = max_iterations - 1
    is_estimated = False
    estimate_complete = max_iterations == 0

    while not estimate_complete:
        N = torch.zeros((size, size), **f64)
        n = torch.zeros(size, **f64)
        w = obs - A @ b
        N[:11, :11] = A.T @ A
        n[:11] = A.T @ w

        active = restrictions if include_restrictions else []
        for r_i, restriction in enumerate(active):
            row, wr = _restriction_row(restriction, b, x0, y0, c)
            N[11 + r_i, :11] = row
            N[:11, 11 + r_i] = row
            n[11 + r_i] = wr

        # Jacobi preconditioning + solve (leading 11 first pass, bordered
        # afterwards; DirectLinearTransformation.java:121-143)
        k = size if include_restrictions else 11
        Nk = N[:k, :k]
        nk = n[:k]
        d = torch.diagonal(Nk)
        V = torch.where(d > EPS,
                        1.0 / torch.sqrt(torch.where(d > EPS, d, 1.0)), 1.0)
        dx = V * torch.linalg.solve(V[:, None] * Nk * V[None, :], V * nk)

        estimate_complete = is_estimated or R == 0
        b = b + dx[:11]
        max_abs_dx = float(dx[:11].abs().max())
        include_restrictions = True

        if not np.isfinite(max_abs_dx):
            return DLTResult(b=b.cpu().numpy(), converged=False)
        elif max_abs_dx <= SQRT_EPS and runs > 0:
            is_estimated = True
        elif runs <= 1:
            if estimate_complete:
                converged = False
            is_estimated = True
            runs -= 1
        else:
            runs -= 1

    return _expand(b.cpu().numpy(), scale, converged)


def _expand(b, scale, converged) -> DLTResult:
    """Decompose DLT coefficients into physical parameters
    (expandUnknownParameters, DirectLinearTransformation.java:185-267):
    x0/y0/c from the b-rows, R orthonormalisation with det-sign fix,
    omega = atan2(-r23, r33), phi = asin(r13), kappa = atan2(-r12, r11),
    projection centre t = -F^{-1} f."""
    b = b.copy()
    # un-scale all but the constant terms b14, b24
    for i in range(11):
        if i not in (3, 7):
            b[i] /= scale

    b11, b12, b13, b14, b21, b22, b23, b24, b31, b32, b33 = b
    b3s = b31 * b31 + b32 * b32 + b33 * b33

    x0 = (b11 * b31 + b12 * b32 + b13 * b33) / b3s
    y0 = (b21 * b31 + b22 * b32 + b23 * b33) / b3s
    cx = math.sqrt((b11 * b11 + b12 * b12 + b13 * b13) / b3s - x0 * x0)
    cy = math.sqrt((b21 * b21 + b22 * b22 + b23 * b23) / b3s - y0 * y0)

    sq = math.sqrt(b3s)
    R = np.array([
        [-(x0 * b31 - b11) / sq / cx, -(y0 * b31 - b21) / sq / cy, -b31 / sq],
        [-(x0 * b32 - b12) / sq / cx, -(y0 * b32 - b22) / sq / cy, -b32 / sq],
        [-(x0 * b33 - b13) / sq / cx, -(y0 * b33 - b23) / sq / cy, -b33 / sq],
    ])
    if np.linalg.det(R) < 0:
        R = -R

    omega = math.atan2(-R[1, 2], R[2, 2])
    phi = math.asin(max(-1.0, min(1.0, R[0, 2])))
    kappa = math.atan2(-R[0, 1], R[0, 0])

    F = np.array([[b11, b12, b13], [b21, b22, b23], [b31, b32, b33]])
    f = np.array([-b14, -b24, -1.0])
    t = np.linalg.solve(F, f)

    result = DLTResult(b=b, converged=converged)
    result.c = 0.5 * (cx + cy)
    result.x0 = x0
    result.y0 = y0
    result.eo = np.array([t[0], t[1], t[2], omega, phi, kappa])
    return result


def apply_to(result: DLTResult, image) -> None:
    """Write the decomposition into the scene graph as starting values,
    skipping held-fixed IO parameters (expandUnknownParameters column
    checks)."""
    io = image.camera.interior_orientation
    if not io.c.fixed:
        io.c.value = result.c
    if not io.x0.fixed:
        io.x0.value = result.x0
    if not io.y0.fixed:
        io.y0.value = result.y0
    image.eo.set(*result.eo)


def triangulate(dlt_list, xy_list, device="cuda") -> np.ndarray:
    """Spatial-resection-style position-only solve: recover an object point
    from >= 2 images with known DLT coefficients
    (addPartialNormalEquationOfUnknownPosition,
    DLTPartialDerivativeFactory.java:346-405), float64 on ``device``."""
    dev = resolve_device(device)
    pairs = list(zip(dlt_list, xy_list))
    b = torch.as_tensor(np.stack([np.asarray(r.b) for r, _ in pairs]),
                        dtype=torch.float64, device=dev)  # [n, 11]
    xy = torch.as_tensor(np.asarray([p for _, p in pairs], np.float64),
                         device=dev)  # [n, 2]
    x, y = xy[:, 0:1], xy[:, 1:2]
    A = torch.cat([b[:, 0:3] - x * b[:, 8:11],
                   b[:, 4:7] - y * b[:, 8:11]], dim=0)  # [2n, 3]
    w = torch.cat([x[:, 0] - b[:, 3], y[:, 0] - b[:, 7]])
    return torch.linalg.solve(A.T @ A, A.T @ w).cpu().numpy()
