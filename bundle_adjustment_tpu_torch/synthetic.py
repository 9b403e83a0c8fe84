"""Synthetic scale network: the port's copy of `bench.build_problem`.

One camera or a rig of C (image m on camera m % C, per-camera IO and
distortion with small true offsets), the distortion stack affinity +
tangential + radial orders 1-3 (K = 7, G = 10 per camera), each point
seen by a fixed number of random images,
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


def predict(points, io, dist, eo, obs_point, obs_image, spec,
            cam_of_image=None):
    """Exact image coordinates [N, 2] of every observation, float64 on the
    CPU through ops.fm; ``cam_of_image`` [M] (default: every image on
    camera 0) picks each observation's row of ``io`` [C, 3] and ``dist``
    [C, K]."""
    from .ops import fm

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    img = torch.as_tensor(obs_image, dtype=torch.long)
    pts = t(points)[torch.as_tensor(obs_point, dtype=torch.long)]
    e = t(eo)[img]
    cam = (torch.zeros_like(img) if cam_of_image is None
           else torch.as_tensor(cam_of_image, dtype=torch.long)[img])
    n = pts.shape[0]
    io_r = [t(io)[cam, a] for a in range(3)]
    coeffs = [t(dist)[cam, k] for k in range(spec.num_coefficients)]
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


def true_eo(num_images):
    """The true exterior orientations [M, 6] of `build_problem` (no random
    draw): images on rings around the field, looking at its centre."""
    eo = np.zeros((num_images, 6))
    R = FIELD * 2.0
    for m in range(num_images):
        ang = 2 * np.pi * m / num_images + 0.37 * (m % 5)
        radius = R * (0.7 + 0.12 * (m % 4))
        height = R * (0.5 + 0.2 * (m % 5))
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        w, p_, k = look_at_wpk(pos, np.zeros(3))
        eo[m] = [*pos, w, p_, k + (m % 4) * np.pi / 2]
    return eo


def build_problem(num_points, num_images, views_per_point, seed=0, spec=None,
                  num_cameras=1):
    """Returns (RCSProblem of host numpy arrays, ParamState of numpy
    arrays, spec); floats are float64 (`convert` casts them).  ``spec``:
    another distortion stack than `scale_spec` (its radial orders 1 and 2
    get the true coefficients below where it has them; Gp = 3 + its
    number of coefficients per camera).  ``num_cameras``: C > 1 builds a
    camera rig as `bench.build_problem` does: image m belongs to camera
    m % C, camera c's true IO is (0.02, -0.03, -30) + 0.01 c (1, -1, 30)
    and its first radial coefficient -1.1e-4 (1 + 0.1 c); G = C Gp."""
    rng = np.random.default_rng(seed)
    pts = _true_points(rng, num_points)

    C = num_cameras
    io = np.array([[0.02, -0.03, -30.0]]) \
        + 0.01 * np.arange(C)[:, None] * np.array([1.0, -1.0, 30.0])
    spec = scale_spec() if spec is None else spec
    K = spec.num_coefficients
    dist = np.zeros((C, K))
    radial = {s.key for s in spec.slots if int(s.kind) == 2}
    for order, value in ((1, -1.1e-4 * (1 + 0.1 * np.arange(C))),
                         (2, 1.5e-7)):
        if order in radial:
            dist[:, spec.slot_index(2, order)] = value

    eo = true_eo(num_images)

    V = views_per_point
    obs_point = np.repeat(np.arange(num_points, dtype=np.int32), V)
    obs_image = rng.integers(0, num_images, num_points * V).astype(np.int32)
    cam_of_image = (np.arange(num_images) % C).astype(np.int32)
    xy = predict(pts, io, dist, eo, obs_point, obs_image, spec, cam_of_image)
    xy = xy + rng.normal(0, SIGMA, xy.shape)

    w2 = np.zeros((xy.shape[0], 2, 2))
    w2[:, 0, 0] = 1.0
    w2[:, 1, 1] = 1.0
    free_point = np.ones((num_points, 3))
    free_point[:3] = 0.0  # fixed-coordinate datum
    free_eo = np.ones((num_images, 6))
    free_global = np.ones(C * (3 + K))

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
        obs_xy=xy, obs_weight=w2, r0=np.full(C, R0),
        num_points=P_pad, num_images=num_images,
        free_point=free_point, free_eo=free_eo, free_global=free_global,
        img_perm=img_perm, img_block_starts=img_bstarts, point_uniform=V,
        cam_of_image=cam_of_image)
    state = ParamState(points=pts0, io=io, dist=dist, eo=eo0)
    return problem, state, spec


def scenario_batch(S, num_points, num_images, views_per_point, seed=0):
    """S one-camera networks that share one index structure (the points,
    the visibility, the true IO / distortion / EO of
    `build_problem(num_points, num_images, views_per_point, seed=seed)`),
    each with its own image noise N(0, SIGMA^2) and its own start (the
    points perturbed by N(0, 0.05^2), the EO by N(0, 1e-10)), drawn from
    ``numpy.random.default_rng([seed, s + 1])`` for scenario s.

    Returns (problem, obs_xy [S, N, 2], obs_weight [S, N, 2, 2], states,
    spec): ``problem`` is `build_problem`'s (host arrays; its own
    observations are not any scenario's), ``states`` a ParamState of numpy
    arrays with a leading S axis (`scenario.make_batch` takes them)."""
    problem, state, spec = build_problem(num_points, num_images,
                                         views_per_point, seed=seed)
    P, V = num_points, views_per_point
    pts, eo = true_points(num_points, seed), true_eo(num_images)
    n = P * V
    exact = predict(pts, state.io, state.dist, eo, problem.obs_point[:n],
                    problem.obs_image[:n], spec)
    free = problem.free_point[:P]
    xys, points, eos = [], [], []
    for s in range(S):
        rng = np.random.default_rng([seed, s + 1])
        xy = np.zeros_like(problem.obs_xy)
        xy[:n] = exact + rng.normal(0, SIGMA, exact.shape)
        p0 = np.array(state.points)
        p0[:P] = pts + rng.normal(0, 0.05, pts.shape) * free
        p0[P:] = p0[0]
        xys.append(xy)
        points.append(p0)
        eos.append(eo + rng.normal(0, 1e-5, eo.shape))
    states = ParamState(points=np.stack(points),
                        io=np.stack([state.io] * S),
                        dist=np.stack([state.dist] * S), eo=np.stack(eos))
    return (problem, np.stack(xys), np.stack([problem.obs_weight] * S),
            states, spec)


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


def as_read_from_files(problem, state):
    """What `io.columnar.build_rcs_problem` builds from the files of
    `write_flat`: the problem and state (host arrays) without the dummy
    points (the trailing points whose observations all weigh 0), with
    r0 = 0 (the files carry no distortion reference radius)."""
    P, V = problem.num_points, problem.point_uniform
    seen = np.asarray(problem.obs_weight)[:, 0, 0].reshape(P, V).sum(axis=1)
    n = int(np.flatnonzero(seen > 0).max()) + 1
    obs_image = np.asarray(problem.obs_image)[:n * V]
    img_perm, img_bstarts = build_image_block_layout(obs_image,
                                                     problem.num_images)
    return problem._replace(
        obs_point=np.asarray(problem.obs_point)[:n * V], obs_image=obs_image,
        obs_xy=np.asarray(problem.obs_xy)[:n * V],
        obs_weight=np.asarray(problem.obs_weight)[:n * V],
        r0=np.zeros_like(np.asarray(problem.r0)), num_points=n,
        free_point=np.asarray(problem.free_point)[:n],
        img_perm=img_perm, img_block_starts=img_bstarts), \
        state._replace(points=np.asarray(state.points)[:n])


def write_flat(base: str, problem, state):
    """Write a one-camera `build_problem` network without its dummy points
    as the generic flat files `io.columnar.build_rcs_problem` reads (17
    significant digits): points named by their index, the datum column on
    the fixed ones; image coordinates `1 <image + 1> <point> x y SIGMA
    SIGMA 0`; EO; IO.  Returns the paths ({points, imagecoords, eor,
    ior})."""
    from .io.scene_files import write_flat_files

    if np.asarray(state.io).shape[0] != 1:
        raise ValueError("write_flat takes a one-camera network")
    p, s = as_read_from_files(problem, state)
    fixed = ~np.asarray(p.free_point, bool).any(axis=1)
    return write_flat_files(
        base, [str(i) for i in range(p.num_points)], s.points, fixed,
        p.obs_point, p.obs_image, p.obs_xy, SIGMA, s.eo, s.io[0])
