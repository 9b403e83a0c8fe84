"""Rotation utilities (port of `bundle_adjustment_tpu/ops/rotation.py`).

The omega-phi-kappa rotation convention follows Luhmann (2023, Eq. 2.30/2.31)
as used by the reference (`.../camera/orientation/ExteriorOrientation.java:52-85`,
`.../derivation/PartialDerivativeFactory.java:124-135`).  Euler extraction for
all twelve axis conventions mirrors `adjustment/MathExtension.java:585-766`.

Every function takes tensors with any leading batch shape (angles [...],
matrices [..., 3, 3]) and is differentiable by `torch.func`.
"""

from __future__ import annotations

import torch


def _mat(rows):
    """[[a, b, c], ...] of [...] tensors -> [..., 3, 3]."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_wpk(omega, phi, kappa):
    """Rotation matrix R(omega, phi, kappa) [..., 3, 3], world -> image axes.

    The collinearity numerators are kx = R[:,0] . d, ky = R[:,1] . d,
    N = R[:,2] . d with d = X - X0 (PartialDerivativeFactory.java:141-143).
    """
    co, so = torch.cos(omega), torch.sin(omega)
    cp, sp = torch.cos(phi), torch.sin(phi)
    ck, sk = torch.cos(kappa), torch.sin(kappa)
    return _mat([
        [cp * ck, -cp * sk, sp],
        [co * sk + so * sp * ck, co * ck - so * sp * sk, -so * cp],
        [so * sk - co * sp * ck, so * ck + co * sp * sk, co * cp],
    ])


def wpk_from_rotation(R):
    """(omega, phi, kappa) of a rotation matrix of the above convention:
    omega = atan2(-r23, r33), phi = asin(r13), kappa = atan2(-r12, r11)."""
    omega = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    phi = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    kappa = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return omega, phi, kappa


def cross(a, b):
    """Vector cross product over the last axis (MathExtension.java:526-534)."""
    return torch.linalg.cross(a, b, dim=-1)


def _rx(a):
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return _mat([[one, zero, zero], [zero, c, s], [zero, -s, c]])


def _ry(a):
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return _mat([[c, zero, -s], [zero, one, zero], [s, zero, c]])


def _rz(a):
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return _mat([[c, s, zero], [-s, c, zero], [zero, zero, one]])


_AXIS_ROTS = {"x": _rx, "y": _ry, "z": _rz}


def sequence_rotation(angles, order: str):
    """R = R_k(c) @ R_j(b) @ R_i(a) for order string like "xyz" with
    angles = (a, b, c); supports all 12 conventions of
    MathExtension.rotationMatrix3D2EulerAngles."""
    if len(order) != 3:
        raise ValueError(f"order must have 3 axes, got {order!r}")
    a, b, c = (torch.as_tensor(x) for x in angles)
    return _AXIS_ROTS[order[2]](c) @ _AXIS_ROTS[order[1]](b) \
        @ _AXIS_ROTS[order[0]](a)


def euler_from_rotation(R, order: str):
    """Inverse of :func:`sequence_rotation`: Euler angles of a proper
    rotation matrix for any of the 12 conventions (MathExtension.java:585-766).

    Conventions with repeated first/last axis (e.g. "xyx") use the
    proper-Euler branch; the six Tait-Bryan conventions use the asin branch.
    """
    i, j, k = order[0], order[1], order[2]
    ax = {"x": 0, "y": 1, "z": 2}
    if i == k:  # proper Euler: i-j-i
        ii, jj = ax[i], ax[j]
        kk = 3 - ii - jj
        sign = 1.0 if (ii, jj) in ((0, 1), (1, 2), (2, 0)) else -1.0
        b = torch.acos(torch.clamp(R[..., ii, ii], -1.0, 1.0))
        a = torch.atan2(R[..., ii, jj], -sign * R[..., ii, kk])
        c = torch.atan2(R[..., jj, ii], sign * R[..., kk, ii])
        return a, b, c
    ii, jj, kk = ax[i], ax[j], ax[k]  # Tait-Bryan: i-j-k, all distinct
    sign = 1.0 if (ii, jj, kk) in ((0, 1, 2), (1, 2, 0), (2, 0, 1)) else -1.0
    b = torch.asin(torch.clamp(sign * R[..., kk, ii], -1.0, 1.0))
    a = torch.atan2(-sign * R[..., kk, jj], R[..., kk, kk])
    c = torch.atan2(-sign * R[..., jj, ii], R[..., ii, ii])
    return a, b, c
