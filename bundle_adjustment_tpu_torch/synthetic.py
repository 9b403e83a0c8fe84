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

`free_network` re-dresses such a problem as a free network: every
coordinate free, the Helmert inner-constraint datum, scale bars and,
optionally, direct observations.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.distortion import DistortionSpecBuilder
from .models.problem import ParamState
from .parallel.rcs import RCSProblem, build_image_block_layout
from .testing import look_at_wpk

#: image noise (sigma0 = sigma: unit weights)
SIGMA = 5e-4
#: distortion reference radius r0
R0 = 10.0


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


#: extent of the object field
FIELD = 2000.0
#: weight of a scale bar (sigma0^2 / sigma_bar^2) and of `free_network`'s
#: default bars; their lengths carry noise of SIGMA / sqrt(BAR_WEIGHT)
BAR_WEIGHT = 1e6


def _true_points(rng, num_points):
    pts = rng.uniform(-FIELD / 2, FIELD / 2, (num_points, 3))
    pts[:, 2] *= 0.2
    return pts


def true_points(num_points, seed=0):
    """The noise-free object points [num_points, 3] of
    `build_problem(num_points, ..., seed=seed)`: its first random draw."""
    return _true_points(np.random.default_rng(seed), num_points)


def build_problem(num_points, num_images, views_per_point, seed=0, spec=None):
    """Returns (RCSProblem of host numpy arrays, ParamState of numpy
    arrays, spec); floats are float64 (`convert` casts them).  ``spec``:
    another distortion stack than `scale_spec` (its radial orders 1 and 2
    get the true coefficients below where it has them; G = 3 + its
    number of coefficients)."""
    rng = np.random.default_rng(seed)
    field = FIELD
    pts = _true_points(rng, num_points)

    io = np.array([[0.02, -0.03, -30.0]])
    spec = scale_spec() if spec is None else spec
    K = spec.num_coefficients
    dist = np.zeros((1, K))
    radial = {s.key for s in spec.slots if int(s.kind) == 2}
    for order, value in ((1, -1.1e-4), (2, 1.5e-7)):
        if order in radial:
            dist[:, spec.slot_index(2, order)] = value

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


def free_network(problem, state, bars=8, direct=None, seed=0, truth=None,
                 datum=True):
    """Re-dress a synthetic problem as a free network (host arrays in,
    host arrays out; made with numpy from ``seed``).  Returns the problem
    with the extra fields of `rcs.RCSProblem` set; ``state`` is only read.

    ``datum``: free every coordinate of the true points and fix the
    network by inner constraints on all of them: ``datum_mask_d`` ones and
    ``defect_flags_d`` = three translations and three rotations (the
    scale is fixed by the bars).  Padded dummy points (those whose
    observations all have zero weight) stay fixed and outside the datum.
    With ``datum=False`` the fixed-coordinate datum stays as it is.

    ``bars``: that many scale bars between seeded pairs of distinct true
    points, weight `BAR_WEIGHT`, length = the distance in ``truth`` [P, 3]
    (default: in ``state.points``) plus N(0, (SIGMA / sqrt(BAR_WEIGHT))^2)
    noise: with unit image weights sigma0 = SIGMA, so the noise agrees
    with the weight and does not move sigma0.

    ``direct``: optional dict of direct observations, each value observed
    at the state's value plus noise that agrees with its weight:
    ``group=n`` a fully populated group of n point coordinates with
    ``dpg_cov`` = U^T U (U = N(0, 1e-4) + 3e-4 I, a cofactor matrix);
    ``dp=k`` diagonal observations of the three coordinates of k points
    (sigma 1e-3); ``de=k`` of the six EO parameters of k images (sigma
    1e-2 for the position, 1e-5 for the angles); ``dg=True`` of the three
    IO parameters (sigma 1e-3)."""
    rng = np.random.default_rng(seed)
    P, V = problem.num_points, problem.point_uniform
    dt = np.asarray(problem.obs_xy).dtype
    pts = np.asarray(state.points, np.float64)
    true_mask = (np.asarray(problem.obs_weight)[:, 0, 0]
                 .reshape(P, V).sum(axis=1) > 0)
    ids = np.flatnonzero(true_mask)
    fields = {}
    if datum:
        fields.update(
            free_point=np.repeat(true_mask[:, None], 3, axis=1).astype(dt),
            datum_mask_d=true_mask.astype(dt),
            defect_flags_d=(True, True, True, True, True, True, False))
    if bars:
        ends = rng.choice(ids, (bars, 2), replace=False)
        ref = pts if truth is None else np.asarray(truth, np.float64)
        length = np.linalg.norm(ref[ends[:, 1]] - ref[ends[:, 0]], axis=1)
        length = length + rng.normal(0, SIGMA / np.sqrt(BAR_WEIGHT), bars)
        fields.update(
            sb_a=ends[:, 0].astype(np.int32), sb_b=ends[:, 1].astype(np.int32),
            sb_length=length.astype(dt),
            sb_weight=np.full(bars, BAR_WEIGHT, dt))
    direct = dict(direct or {})
    n = direct.pop("group", 0)
    if n:
        idx = rng.choice(ids, n, replace=False)
        axis = rng.integers(0, 3, n)
        U = rng.normal(0, 1e-4, (n, n)) + np.eye(n) * 3e-4
        fields.update(
            dpg_idx=idx.astype(np.int32), dpg_axis=axis.astype(np.int32),
            dpg_val=(pts[idx, axis]
                     + SIGMA * U.T @ rng.normal(0, 1, n)).astype(dt),
            dpg_cov=(U.T @ U).astype(dt))

    def diagonal(values, rows, sigma):
        """(weights, observed values): SIGMA^2 / sigma^2 on ``rows``."""
        w = np.zeros(values.shape)
        w[rows] = (SIGMA / sigma) ** 2
        return w.astype(dt), (values + rng.normal(0, 1, values.shape)
                              * sigma * (w > 0)).astype(dt)

    k = direct.pop("dp", 0)
    if k:
        fields["dp_w"], fields["dp_val"] = diagonal(
            pts, rng.choice(ids, k, replace=False), 1e-3)
    k = direct.pop("de", 0)
    if k:
        eo = np.asarray(state.eo, np.float64)
        fields["de_w"], fields["de_val"] = diagonal(
            eo, rng.choice(eo.shape[0], k, replace=False),
            np.array([1e-2] * 3 + [1e-5] * 3))
    if direct.pop("dg", False):
        g = np.concatenate([np.asarray(state.io, np.float64),
                            np.asarray(state.dist, np.float64)],
                           axis=1).reshape(-1)
        fields["dg_w"], fields["dg_val"] = diagonal(g, slice(0, 3), 1e-3)
    if direct:
        raise ValueError(f"unknown direct observations: {sorted(direct)}")
    return problem._replace(**fields)
