"""The synthetic scale network with uneven visibility, frozen: numpy only.

A copy of `bundle_adjustment_tpu_torch.synthetic.thin_views` over
`network.build`: from a network whose every point is seen by ``V``
images (drawn with replacement), point p keeps all V of its views where
p % ``every`` == 0 and its first ``views`` elsewhere; the dummy points
are dropped; the observations are in file order, grouped by image (a
stable sort by image, as an image-coordinate file lists them), with the
blocked image layout rebuilt and ``point_uniform`` None.  The kept rows
are chosen as `synthetic.thin_rows` chooses them, so `thin` gives the
arrays of `thin_views(build_problem(...))` bit for bit
(`tests/test_portbench_uneven.py` holds the two together by
`synthetic.digest`).

The image noise and the starts follow `network`'s laws on the network
before it is thinned (`synthetic.thin_scenarios`): `network.scenario`
draws the noise of every one of its rows and `thin` keeps those of the
kept rows; `job_start` draws job j's start on it and drops the dummy
points.
"""

from __future__ import annotations

import numpy as np

from benchmark.inputs import network


def thin_rows(net: network.Network, views, every) -> np.ndarray:
    """The rows [N'] int64 of ``net`` that `thin` keeps, in file order."""
    P, V, n = net.num_points, net.point_uniform, net.real_points
    pt = np.repeat(np.arange(P), V)
    view = np.tile(np.arange(V), P)
    keep = np.flatnonzero((pt < n) & ((view < views) | (pt % every == 0)))
    return keep[np.argsort(net.obs_image[keep], kind="stable")]


def thin(net: network.Network, views, every) -> network.Network:
    """``net`` (point-major, as `network.build` or `network.scenario` give
    it) cut to the uneven visibility above, in file order: its real
    points only, ``point_uniform`` None, ``obs_exact`` in the kept rows'
    order."""
    rows = thin_rows(net, views, every)
    n = net.real_points
    obs_image = net.obs_image[rows]
    img_perm, img_bstarts = network.image_block_layout(obs_image,
                                                       net.num_images)
    return net._replace(
        obs_point=net.obs_point[rows], obs_image=obs_image,
        obs_xy=net.obs_xy[rows], obs_weight=net.obs_weight[rows],
        num_points=n, free_point=net.free_point[:n], img_perm=img_perm,
        img_block_starts=img_bstarts, point_uniform=None,
        points0=net.points0[:n], obs_exact=net.obs_exact[rows])


def job_start(net: network.Network, seed, j):
    """Job j's start (points [real_points, 3], eo [M, 6]) on the thinned
    network of ``net`` (the network before `thin`): `network.job_start`'s
    draws, the dummy points dropped."""
    pts, eo = network.job_start(net, seed, j)
    return pts[:net.real_points], eo
