"""The synthetic scale network as a camera rig, frozen: numpy only.

A copy of `bundle_adjustment_tpu_torch.synthetic.build_problem(...,
num_cameras=C)` built from `network`'s pieces: image m is on camera
m % C; camera c's true IO is (0.02, -0.03, -30) + 0.01 c (1, -1, 30) and
its first radial coefficient -1.1e-4 (1 + 0.1 c), the second 1.5e-7 as the
one camera's; every camera has its own IO and distortion unknowns (G =
10 C).  The random draws are those of the one-camera network, in the same
order from the same generator, so the points, the visibility, the noise
draws and the start are `network.build`'s; only the forward model differs,
camera by camera (`network.predict` on each camera's observations: the
model is elementwise, so the subsets give the bits of one pass).
`tests/test_portbench_rig.py` holds `build` to the port's `build_problem`
by `synthetic.digest`.  `network.scenario` and `network.job_start` take
the rig as they take the one-camera network.
"""

from __future__ import annotations

import numpy as np

from benchmark.inputs import network


def camera_io(num_cameras) -> np.ndarray:
    """The true IO [C, 3] (x0, y0, c) of each camera."""
    return np.array([network.IO]) + 0.01 * np.arange(num_cameras)[:, None] \
        * np.array([1.0, -1.0, 30.0])


def camera_dist(num_cameras) -> np.ndarray:
    """The true distortion [C, K] of each camera (`network.DIST`'s order);
    the first radial coefficient grows by a tenth per camera."""
    dist = np.zeros((num_cameras, network.K))
    dist[:, 4] = -1.1e-4 * (1 + 0.1 * np.arange(num_cameras))
    dist[:, 5] = 1.5e-7
    return dist


def predict(points, eo, obs_point, obs_image, cam_of_image, io, dist):
    """Exact image coordinates [N, 2] of every observation, each through
    its image's camera (``io`` [C, 3], ``dist`` [C, K])."""
    out = np.empty((obs_image.shape[0], 2))
    cam = cam_of_image[obs_image]
    for c in range(io.shape[0]):
        sel = np.flatnonzero(cam == c)
        out[sel] = network.predict(points, eo, obs_point[sel],
                                   obs_image[sel], io=io[c], dist=dist[c])
    return out


def build(num_points, num_images, views, seed, num_cameras) -> network.Network:
    """The network of `build_problem(num_points, num_images, views,
    seed=seed, num_cameras=num_cameras)`."""
    C = num_cameras
    rng = np.random.default_rng(seed)
    pts = network.true_points(rng, num_points)
    io, dist = camera_io(C), camera_dist(C)
    eo = network.true_eo(num_images)
    V = views
    obs_point = np.repeat(np.arange(num_points, dtype=np.int32), V)
    obs_image = rng.integers(0, num_images, num_points * V).astype(np.int32)
    cam_of_image = (np.arange(num_images) % C).astype(np.int32)
    exact = predict(pts, eo, obs_point, obs_image, cam_of_image, io, dist)
    xy = exact + rng.normal(0, network.SIGMA, exact.shape)
    w2 = np.zeros((xy.shape[0], 2, 2))
    w2[:, 0, 0] = 1.0
    w2[:, 1, 1] = 1.0
    free_point = np.ones((num_points, 3))
    free_point[:3] = 0.0
    pts0 = pts + rng.normal(0, network.START_POINT_SIGMA, pts.shape) \
        * free_point
    eo0 = eo + rng.normal(0, network.START_EO_SIGMA, eo.shape)
    P_pad = -(-num_points // network.PAD) * network.PAD
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
    img_perm, img_bstarts = network.image_block_layout(obs_image, num_images)
    return network.Network(
        obs_point=obs_point, obs_image=obs_image, obs_xy=xy, obs_weight=w2,
        r0=np.full(C, network.R0), num_points=P_pad, num_images=num_images,
        free_point=free_point, free_eo=np.ones((num_images, 6)),
        free_global=np.ones(C * (3 + network.K)), img_perm=img_perm,
        img_block_starts=img_bstarts, point_uniform=V,
        cam_of_image=cam_of_image, points0=pts0, eo0=eo0, io=io, dist=dist,
        real_points=num_points, points_true=pts, eo_true=eo, obs_exact=exact,
        seed=seed)
