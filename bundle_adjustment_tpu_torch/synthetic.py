"""Synthetic scale network: the port's copy of `bench.build_problem`.

Single camera, the distortion stack affinity + tangential + radial orders
1-3 (K = 7, G = 10), each point seen by a fixed number of random images,
observations from the exact forward model plus N(0, sigma^2) noise, and a
perturbed start.  The random draws happen in exactly the order of
`bench.build_problem` from ``numpy.random.default_rng(seed)``, so the same
seed gives the same points, visibility, noise and start.  The forward model
is the port's own `ops.fm`, evaluated in float64 on the CPU.

Points are padded to a multiple of 512 with zero-weight, fixed dummy
points (bench.py's ``pad128=True``).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.distortion import DistortionSpecBuilder
from .models.problem import ParamState
from .parallel.rcs import RCSProblem, build_image_block_layout

#: image noise (sigma0 = sigma: unit weights)
SIGMA = 5e-4
#: distortion reference radius r0
R0 = 10.0


def look_at_wpk(cam_pos, target):
    """omega/phi/kappa whose rotation's third column points from cam_pos
    towards target (Luhmann convention)."""
    f = np.asarray(target, float) - np.asarray(cam_pos, float)
    f = f / np.linalg.norm(f)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, f)) > 0.95:
        up = np.array([0.0, 1.0, 0.0])
    s = np.cross(up, f)
    s /= np.linalg.norm(s)
    u = np.cross(f, s)
    R = np.stack([s, u, f], axis=1)  # columns
    omega = np.arctan2(-R[1, 2], R[2, 2])
    phi = np.arcsin(np.clip(R[0, 2], -1, 1))
    kappa = np.arctan2(-R[0, 1], R[0, 0])
    return omega, phi, kappa


def scale_spec():
    """Affinity + tangential + radial orders 1-3 (K = 7)."""
    builder = DistortionSpecBuilder()
    builder.add_affinity()
    builder.add_tangential()
    builder.add_radial_order(1)
    builder.add_radial_order(2)
    builder.add_radial_order(3)
    return builder.build()


def predict(points, io, dist, eo, obs_point, obs_image, spec):
    """Exact image coordinates [N, 2] of every observation, float64 on the
    CPU through ops.fm."""
    from .ops import fm

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    pts = t(points)[torch.as_tensor(obs_point, dtype=torch.long)]
    e = t(eo)[torch.as_tensor(obs_image, dtype=torch.long)]
    n = pts.shape[0]
    io_r = [t(io)[0, a].expand(n) for a in range(3)]
    coeffs = [t(dist)[0, k].expand(n) for k in range(spec.num_coefficients)]
    r0 = torch.full((n,), R0, dtype=torch.float64)
    _, _, px, py = fm.jacobian_rows(
        pts[:, 0], pts[:, 1], pts[:, 2], io_r[0], io_r[1], io_r[2],
        e[:, 0], e[:, 1], e[:, 2], e[:, 3], e[:, 4], e[:, 5],
        coeffs, spec, r0)
    return torch.stack([px, py], dim=1).numpy()


def build_problem(num_points, num_images, views_per_point, seed=0):
    """Returns (RCSProblem of host numpy arrays, ParamState of numpy
    arrays, spec); floats are float64 (`convert` casts them)."""
    rng = np.random.default_rng(seed)
    field = 2000.0
    pts = rng.uniform(-field / 2, field / 2, (num_points, 3))
    pts[:, 2] *= 0.2

    io = np.array([[0.02, -0.03, -30.0]])
    spec = scale_spec()
    K = spec.num_coefficients
    dist = np.zeros((1, K))
    dist[:, spec.slot_index(2, 1)] = -1.1e-4
    dist[:, spec.slot_index(2, 2)] = 1.5e-7

    eo = np.zeros((num_images, 6))
    R = field * 2.0
    for m in range(num_images):
        ang = 2 * np.pi * m / num_images + 0.37 * (m % 5)
        radius = R * (0.7 + 0.12 * (m % 4))
        height = R * (0.5 + 0.2 * (m % 5))
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        w, p_, k = look_at_wpk(pos, np.zeros(3))
        eo[m] = [*pos, w, p_, k + (m % 4) * np.pi / 2]

    V = views_per_point
    obs_point = np.repeat(np.arange(num_points, dtype=np.int32), V)
    obs_image = rng.integers(0, num_images, num_points * V).astype(np.int32)
    xy = predict(pts, io, dist, eo, obs_point, obs_image, spec)
    xy = xy + rng.normal(0, SIGMA, xy.shape)

    w2 = np.zeros((xy.shape[0], 2, 2))
    w2[:, 0, 0] = 1.0
    w2[:, 1, 1] = 1.0
    free_point = np.ones((num_points, 3))
    free_point[:3] = 0.0  # fixed-coordinate datum
    free_eo = np.ones((num_images, 6))
    free_global = np.ones(3 + K)

    pts0 = pts + rng.normal(0, 0.05, pts.shape) * free_point
    eo0 = eo + rng.normal(0, 1e-5, eo.shape)

    # zero-weight dummy points copying point 0, marked fixed
    P_pad = -(-num_points // 512) * 512
    extra = P_pad - num_points
    if extra:
        obs_point = np.concatenate(
            [obs_point, np.repeat(np.arange(num_points, P_pad,
                                            dtype=np.int32), V)])
        obs_image = np.concatenate([obs_image, np.zeros(extra * V, np.int32)])
        xy = np.concatenate([xy, np.zeros((extra * V, 2))])
        w2 = np.concatenate([w2, np.zeros((extra * V, 2, 2))])
        free_point = np.concatenate([free_point, np.zeros((extra, 3))])
        pts0 = np.concatenate([pts0, np.broadcast_to(pts0[0], (extra, 3))])

    img_perm, img_bstarts = build_image_block_layout(obs_image, num_images)
    problem = RCSProblem(
        obs_point=obs_point, obs_image=obs_image,
        obs_xy=xy, obs_weight=w2, r0=np.full(1, R0),
        num_points=P_pad, num_images=num_images,
        free_point=free_point, free_eo=free_eo, free_global=free_global,
        img_perm=img_perm, img_block_starts=img_bstarts, point_uniform=V)
    state = ParamState(points=pts0, io=io, dist=dist, eo=eo0)
    return problem, state, spec
