"""Synthetic scene generation for tests and benchmarks (port of
`bundle_adjustment_tpu/testing.py`).

`make_synthetic_scene` draws from its seeded generator in the same order
as the JAX package's, so one seed gives the same scene; the exact
projections of all (image, point) pairs are taken in one batched call of
the port's forward model (float64 on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.distortion import DistortionType
from .models.scene import Camera, ObjectCoordinate, ScaleBar
from .ops.residuals import predict_image_point


def look_at_wpk(cam_pos, target):
    """omega/phi/kappa such that the camera's optical axis (third rotated
    axis) points from cam_pos towards target (negative N convention: object
    in front of the camera has N < 0 since xs = -c*kx/N with c < 0 in the
    AICON convention, or N > 0 with c > 0; only |N| > 0 is needed)."""
    f = np.asarray(target, float) - np.asarray(cam_pos, float)
    f = f / np.linalg.norm(f)
    # rotation with rows [r1; r2; r3] whose third *column* is f, so that
    # N = R[:,2] . d has |N| ~ |d|: an orthonormal frame around f
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, f)) > 0.95:
        up = np.array([0.0, 1.0, 0.0])
    s = np.cross(up, f)
    s /= np.linalg.norm(s)
    u = np.cross(f, s)
    R = np.stack([s, u, f], axis=1)  # columns
    # wpk of this R under the Luhmann convention
    omega = np.arctan2(-R[1, 2], R[2, 2])
    phi = np.arcsin(np.clip(R[0, 2], -1, 1))
    kappa = np.arctan2(-R[0, 1], R[0, 0])
    return omega, phi, kappa


def make_synthetic_scene(
    num_points: int = 50,
    num_images: int = 8,
    noise: float = 0.0,
    sigma: float = 5e-4,
    seed: int = 0,
    with_distortion: bool = True,
    with_scale_bar: bool = True,
    perturb: float = 0.0,
    field_size: float = 100.0,
    camera_distance: float = 300.0,
):
    """Builds a single-camera synthetic target-field network.

    Points in a slab around the origin; cameras on a ring looking at the
    origin; exact projections (plus optional Gaussian noise) as
    observations, kept where |x|, |y| <= 50 (the image format).
    Returns (cameras, scale_bars, truth_dict).
    """
    rng = np.random.default_rng(seed)

    pts = rng.uniform(-field_size / 2, field_size / 2, (num_points, 3))
    pts[:, 2] *= 0.2  # flatten -> target field

    c_true = -30.0  # principal distance (AICON sign convention: negative)
    io_true = np.array([0.02, -0.03, c_true])

    types = (
        (DistortionType.RADIAL_DISTORTION, DistortionType.TANGENTIAL_DISTORTION,
         DistortionType.AFFINITY_AND_SHEAR)
        if with_distortion else ()
    )
    cam = Camera(1, r0=10.0, distortion_types=types)
    cam.io.x0.value = io_true[0]
    cam.io.y0.value = io_true[1]
    cam.io.c.value = io_true[2]

    dist_true = {}
    if with_distortion:
        rad = cam.distortion(DistortionType.RADIAL_DISTORTION)
        a1 = rad.add(1, -1.1e-4)
        a2 = rad.add(2, 1.5e-7)
        tan = cam.distortion(DistortionType.TANGENTIAL_DISTORTION)
        tan.bx.value = 5.8e-6
        tan.bx.fixed = False
        tan.by.value = -8.6e-6
        tan.by.fixed = False
        aff = cam.distortion(DistortionType.AFFINITY_AND_SHEAR)
        aff.cx.value = -7.0e-5
        aff.cx.fixed = False
        aff.cy.value = -3.1e-5
        aff.cy.fixed = False
        dist_true = {"A1": a1.value, "A2": a2.value, "Bx": tan.bx.value,
                     "By": tan.by.value, "Cx": aff.cx.value, "Cy": aff.cy.value}

    coords = [ObjectCoordinate(str(i + 1), *pts[i]) for i in range(num_points)]

    spec = cam.build_spec()
    coeff_template = np.zeros(spec.num_coefficients)
    if with_distortion:
        for kind in sorted(cam.distortion_models.keys()):
            for key, par in cam.distortion_models[kind].coefficients:
                coeff_template[spec.slot_index(kind, key)] = par.value

    # A proper self-calibration geometry: varied distances and elevations
    # plus 90-degree camera rolls (kappa diversity decorrelates the IO and
    # distortion parameters from the network geometry).
    eo_true = np.zeros((num_images, 6))
    for m in range(num_images):
        ang = 2 * np.pi * m / num_images + 0.3 * (m % 3)
        radius = camera_distance * (0.7 + 0.15 * (m % 4))
        height = camera_distance * (0.4 + 0.25 * (m % 5))
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        w, p_, k = look_at_wpk(pos, np.zeros(3))
        k = k + (m % 4) * np.pi / 2  # rolled camera
        eo_true[m] = [pos[0], pos[1], pos[2], w, p_, k]
        img = cam.add_image(m + 1)
        img.eo.set(*eo_true[m])

    # exact forward model of every (image, point) pair, image-major
    P, M = num_points, num_images
    local = np.concatenate([
        np.broadcast_to(pts[None], (M, P, 3)),
        np.broadcast_to(io_true, (M, P, 3)),
        np.broadcast_to(eo_true[:, None], (M, P, 6)),
        np.broadcast_to(coeff_template, (M, P, spec.num_coefficients)),
    ], axis=2)
    xy_all = predict_image_point(torch.as_tensor(local), spec,
                                 torch.tensor(cam.r0)).numpy()
    keep = np.isfinite(xy_all).all(axis=2) & (np.abs(xy_all).max(axis=2) <= 50)

    # one noise pair per kept pair, in the same order as one draw each
    img_of, pt_of = np.nonzero(keep)
    xy = xy_all[img_of, pt_of]
    if noise > 0:
        xy = xy + rng.normal(0.0, noise, xy.shape)
    images = cam.images
    for m, i, (x, y) in zip(img_of.tolist(), pt_of.tolist(), xy.tolist()):
        images[m].add(coords[i], x, y, sigma, sigma)

    scale_bars = []
    if with_scale_bar:
        d = float(np.linalg.norm(pts[1] - pts[0]))
        scale_bars.append(ScaleBar(coords[0], coords[1], d, 0.01))

    # optionally perturb initial values away from the truth
    if perturb > 0:
        for oc in coords:
            oc.x.value += rng.normal(0, perturb)
            oc.y.value += rng.normal(0, perturb)
            oc.z.value += rng.normal(0, perturb)
        for img in cam:
            img.eo.x0.value += rng.normal(0, perturb)
            img.eo.y0.value += rng.normal(0, perturb)
            img.eo.z0.value += rng.normal(0, perturb)
            img.eo.omega.value += rng.normal(0, perturb * 1e-3)
            img.eo.phi.value += rng.normal(0, perturb * 1e-3)
            img.eo.kappa.value += rng.normal(0, perturb * 1e-3)

    truth = {"points": pts, "io": io_true, "eo": eo_true, "dist": dist_true,
             "coords": coords}
    return [cam], scale_bars, truth
