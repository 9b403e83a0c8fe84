"""The synthetic scale network, frozen: numpy only.

A copy of `bundle_adjustment_tpu_torch.synthetic.build_problem` for one
camera (its `true_points`, `true_eo`, `predict` and the blocked image
layout of `parallel.rcs.build_image_block_layout`), and of the law by which
`synthetic.scenario_batch` draws a start for scenario s.  Every random draw
happens in the same order from the same generator, and every floating-point
operation of the forward model in the same order, so `build` gives the
arrays of `build_problem(points, images, views, seed)` bit for bit
(`tests/test_portbench_inputs.py` holds the two together).

The camera: IO (x0, y0, c) = (0.02, -0.03, -30), distortion stack affinity
(Cx, Cy) + tangential (Bx, By) + radial orders 1-3 (K = 7, G = 10), true
radial coefficients -1.1e-4 and 1.5e-7, reference radius 10.  Points
uniform in a 2000 x 2000 x 400 field, each seen by ``views`` images drawn
with replacement, image noise N(0, 5e-4^2), the first three points held
fixed (the datum), padded to a multiple of 512 points with zero-weight
fixed dummy points that copy point 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

#: image noise (sigma0 with unit weights)
SIGMA = 5e-4
#: distortion reference radius
R0 = 10.0
#: extent of the object field
FIELD = 2000.0
#: true IO (x0, y0, c) of the one camera
IO = (0.02, -0.03, -30.0)
#: number of distortion coefficients: Cx, Cy, Bx, By, k1, k2, k3
K = 7
#: true distortion coefficients in that order
DIST = (0.0, 0.0, 0.0, 0.0, -1.1e-4, 1.5e-7, 0.0)
#: points are padded to a multiple of this
PAD = 512
#: the image layout's block (rows per block of one image)
IMG_BLOCK = 512
#: observations per forward-model chunk (the generator's own; the
#: arithmetic is elementwise, so the chunking does not change a bit)
PREDICT_CHUNK = 1 << 18
#: start law of job j (`synthetic.scenario_batch`): N(0, s^2) added to the
#: free point coordinates and to the EO
START_POINT_SIGMA = 0.05
START_EO_SIGMA = 1e-5


class Network(NamedTuple):
    """The arrays of `build_problem` (the fields of the port's
    RCSProblem / ParamState of host arrays) and the truth."""

    obs_point: np.ndarray     # [N] int32, point-major, padded
    obs_image: np.ndarray     # [N] int32
    obs_xy: np.ndarray        # [N, 2] float64
    obs_weight: np.ndarray    # [N, 2, 2] float64 (0 on the dummy points)
    r0: np.ndarray            # [1]
    num_points: int           # padded
    num_images: int
    free_point: np.ndarray    # [P, 3]
    free_eo: np.ndarray       # [M, 6]
    free_global: np.ndarray   # [G]
    img_perm: np.ndarray      # [Nip] int32
    img_block_starts: np.ndarray  # [M + 1] int32
    point_uniform: int        # views
    cam_of_image: np.ndarray  # [M] int32
    # the state of build_problem (its own perturbed start)
    points0: np.ndarray       # [P, 3]
    eo0: np.ndarray           # [M, 6]
    io: np.ndarray            # [1, 3]
    dist: np.ndarray          # [1, K]
    # the truth
    real_points: int          # points before the dummies
    points_true: np.ndarray   # [real_points, 3]
    eo_true: np.ndarray       # [M, 6]
    obs_exact: np.ndarray     # [real_points V, 2] the noise-free xy
    seed: int                 # of build

    def problem_fields(self) -> dict:
        """The fields of the port's RCSProblem."""
        names = ("obs_point", "obs_image", "obs_xy", "obs_weight", "r0",
                 "num_points", "num_images", "free_point", "free_eo",
                 "free_global", "img_perm", "img_block_starts",
                 "point_uniform", "cam_of_image")
        return {n: getattr(self, n) for n in names}

    def state_fields(self) -> dict:
        """The fields of the port's ParamState (build_problem's start)."""
        return dict(points=self.points0, io=self.io, dist=self.dist,
                    eo=self.eo0)

    def truth_fields(self) -> dict:
        """The true parameters as a ParamState's fields; the dummy points
        copy true point 0."""
        pts = np.concatenate([self.points_true, np.broadcast_to(
            self.points_true[0], (self.num_points - self.real_points, 3))])
        return dict(points=pts, io=self.io, dist=self.dist, eo=self.eo_true)


def true_points(rng, num_points):
    pts = rng.uniform(-FIELD / 2, FIELD / 2, (num_points, 3))
    pts[:, 2] *= 0.2
    return pts


def true_eo(num_images):
    """Images on rings around the field, looking at its centre."""
    m = np.arange(num_images)
    R = FIELD * 2.0
    ang = 2 * np.pi * m / num_images + 0.37 * (m % 5)
    radius = R * (0.7 + 0.12 * (m % 4))
    height = R * (0.5 + 0.2 * (m % 5))
    pos = np.stack([radius * np.cos(ang), radius * np.sin(ang), height],
                   axis=1)

    def unit(x):
        return x / np.sqrt(x[:, None, :] @ x[:, :, None])[:, 0]

    f = unit(0.0 - pos)
    up = np.where((np.abs(f[:, 2]) > 0.95)[:, None], [0.0, 1.0, 0.0],
                  [0.0, 0.0, 1.0])
    s = unit(np.cross(up, f))
    u = np.cross(f, s)
    omega = np.arctan2(-f[:, 1], f[:, 2])
    phi = np.arcsin(np.clip(f[:, 0], -1, 1))
    kappa = np.arctan2(-u[:, 0], s[:, 0]) + (m % 4) * np.pi / 2
    return np.concatenate([pos, np.stack([omega, phi, kappa], axis=1)],
                          axis=1)


def rotation(eo):
    """The nine rotation entries [9, M] of R(omega, phi, kappa)."""
    co, so = np.cos(eo[:, 3]), np.sin(eo[:, 3])
    cp, sp = np.cos(eo[:, 4]), np.sin(eo[:, 4])
    ck, sk = np.cos(eo[:, 5]), np.sin(eo[:, 5])
    return np.stack([cp * ck, -cp * sk, sp,
                     co * sk + so * sp * ck, co * ck - so * sp * sk, -so * cp,
                     so * sk - co * sp * ck, so * ck + co * sp * sk, co * cp])


def predict(points, eo, obs_point, obs_image, io=IO, dist=DIST):
    """Exact image coordinates [N, 2] of every observation (float64):
    collinearity, then affinity, tangential and radial distortion."""
    rot = rotation(np.asarray(eo, np.float64))
    x0, y0, c = (float(v) for v in io)
    cx, cy, bx, by, k1, k2, k3 = (float(v) for v in dist)
    out = np.empty((obs_image.shape[0], 2))
    r02 = R0 * R0
    for c0 in range(0, obs_image.shape[0], PREDICT_CHUNK):
        img = obs_image[c0:c0 + PREDICT_CHUNK]
        r11, r12, r13, r21, r22, r23, r31, r32, r33 = rot[:, img]
        pts = points[obs_point[c0:c0 + PREDICT_CHUNK]]
        e = eo[img]
        dX = pts[:, 0] - e[:, 0]
        dY = pts[:, 1] - e[:, 1]
        dZ = pts[:, 2] - e[:, 2]
        kx = r11 * dX + r21 * dY + r31 * dZ
        ky = r12 * dX + r22 * dY + r32 * dZ
        nd = r13 * dX + r23 * dY + r33 * dZ
        xs = -c * kx / nd
        ys = -c * ky / nd
        r2 = xs * xs + ys * ys
        dx = cx * xs
        dx = dx + cy * ys
        dy = np.zeros_like(ys)
        for k, ck in ((1, k1), (2, k2), (3, k3)):
            dradi = ck * (r2 ** k - r02 ** k)
            dx = dx + xs * dradi
            dy = dy + ys * dradi
        base_x = bx * (r2 + 2.0 * xs * xs) + by * (2.0 * xs * ys)
        base_y = by * (r2 + 2.0 * ys * ys) + bx * (2.0 * xs * ys)
        out[c0:c0 + img.shape[0], 0] = x0 + xs + (dx + base_x)
        out[c0:c0 + img.shape[0], 1] = y0 + ys + (dy + base_y)
    return out


def image_block_layout(obs_image, num_images, block=IMG_BLOCK):
    """Permutation into image-sorted order, each image padded to a
    multiple of ``block`` (pad entries = N); (perm, block starts)."""
    N = obs_image.shape[0]
    key = (obs_image.astype(np.int16) if num_images <= 1 << 15
           else obs_image)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(obs_image, minlength=num_images)
    padded = ((counts + block - 1) // block) * block
    starts = np.concatenate([[0], np.cumsum(padded)])
    perm = np.full(int(starts[-1]), N, np.int32)
    src = 0
    for m in range(num_images):
        n = int(counts[m])
        perm[starts[m]:starts[m] + n] = order[src:src + n]
        src += n
    return perm, (starts // block).astype(np.int32)


def build(num_points, num_images, views, seed) -> Network:
    """The network of `build_problem(num_points, num_images, views,
    seed=seed)` for one camera."""
    rng = np.random.default_rng(seed)
    pts = true_points(rng, num_points)
    io = np.array([IO])
    dist = np.array([DIST])
    eo = true_eo(num_images)
    V = views
    obs_point = np.repeat(np.arange(num_points, dtype=np.int32), V)
    obs_image = rng.integers(0, num_images, num_points * V).astype(np.int32)
    exact = predict(pts, eo, obs_point, obs_image)
    xy = exact + rng.normal(0, SIGMA, exact.shape)
    w2 = np.zeros((xy.shape[0], 2, 2))
    w2[:, 0, 0] = 1.0
    w2[:, 1, 1] = 1.0
    free_point = np.ones((num_points, 3))
    free_point[:3] = 0.0
    pts0 = pts + rng.normal(0, START_POINT_SIGMA, pts.shape) * free_point
    eo0 = eo + rng.normal(0, START_EO_SIGMA, eo.shape)
    P_pad = -(-num_points // PAD) * PAD
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
    img_perm, img_bstarts = image_block_layout(obs_image, num_images)
    return Network(
        obs_point=obs_point, obs_image=obs_image, obs_xy=xy, obs_weight=w2,
        r0=np.full(1, R0), num_points=P_pad, num_images=num_images,
        free_point=free_point, free_eo=np.ones((num_images, 6)),
        free_global=np.ones(3 + K), img_perm=img_perm,
        img_block_starts=img_bstarts, point_uniform=V,
        cam_of_image=np.zeros(num_images, np.int32),
        points0=pts0, eo0=eo0, io=io, dist=dist,
        real_points=num_points, points_true=pts, eo_true=eo, obs_exact=exact,
        seed=seed)


def scenario(net: Network, s) -> Network:
    """Scenario s of `synthetic.scenario_batch` on ``net``'s geometry:
    the same points, visibility and true parameters, the image noise
    N(0, 5e-4^2) drawn anew from ``default_rng([net.seed, s + 1])`` (the
    first draw of that scenario; the dummy points' rows stay 0).  The
    start fields are left as ``net``'s."""
    rng = np.random.default_rng([net.seed, s + 1])
    xy = np.zeros_like(net.obs_xy)
    n = net.obs_exact.shape[0]
    xy[:n] = net.obs_exact + rng.normal(0, SIGMA, net.obs_exact.shape)
    return net._replace(obs_xy=xy)


def job_start(net: Network, seed, j):
    """Job j's start (points [P, 3], eo [M, 6]) by `scenario_batch`'s law
    for scenario j: ``default_rng([seed, j + 1])`` draws the scenario's
    image noise first (not used here: the network keeps its own), then
    N(0, 0.05^2) on the free point coordinates and N(0, 1e-5^2) on the
    EO; the dummy points copy point 0.  IO and distortion start at their
    true values."""
    n = net.real_points
    rng = np.random.default_rng([seed, j + 1])
    rng.normal(0, SIGMA, (n * net.point_uniform, 2))
    pts = np.empty((net.num_points, 3))
    pts[:n] = net.points_true + rng.normal(
        0, START_POINT_SIGMA, (n, 3)) * net.free_point[:n]
    pts[n:] = pts[0]
    eo = net.eo_true + rng.normal(0, START_EO_SIGMA, net.eo_true.shape)
    return pts, eo
