"""Rigid transformation of object points into image frames with full
covariance propagation (port of
`bundle_adjustment_tpu/init/transformation.py`).

Re-design of `tranformation/CoordinateTransformationExteriorOrientation.java`
(survey G5): each (reference image, source image, point) triple transforms
the point through the source image's exterior orientation and out through
the reference image's frame:

    d      = R_src^T (X - X0_src)          (camera coordinates, source)
    X_trg  = X0_trg + R_trg d              (re-expressed via target EO)

and the full bundle covariance is propagated:  Sigma = sigma^2 J Qxx J^T,
where J is the sparse Jacobian over (EO_trg[6], EO_src[6], X_src[3]).

The reference hand-codes ~60 closed-form partials (:131-320); here the rows
are forward-mode AD of :func:`_transform_one` (`torch.func.jacfwd` under
`vmap`) — the same analytic Jacobian, machine-derived.  The propagation
gathers the relevant 15x15 sub-blocks of Qxx instead of materialising the
sparse J, in float64 on the device that holds Qxx.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.rotation import rotation_wpk


def _transform_one(params):
    """params = [eo_trg(6), eo_src(6), X_src(3)] -> transformed point [3]."""
    eo_trg = params[0:6]
    eo_src = params[6:12]
    X = params[12:15]
    R_src = rotation_wpk(eo_src[3], eo_src[4], eo_src[5])
    R_trg = rotation_wpk(eo_trg[3], eo_trg[4], eo_trg[5])
    d = R_src.T @ (X - eo_src[:3])
    return eo_trg[:3] + R_trg @ d


_transform_batch = torch.func.vmap(_transform_one)
_jacobian_batch = torch.func.vmap(torch.func.jacfwd(_transform_one))


@dataclass
class TransformedCoordinates:
    """Result: transformed points (ordered as processed) and their fully
    populated covariance matrix [3n, 3n], host float64 arrays."""

    names: list[str] = field(default_factory=list)
    points: np.ndarray = None  # [n, 3]
    covariance: np.ndarray = None  # [3n, 3n]


def transform(object_coordinates, images_to_align: dict, sigma2: float,
              Qxx) -> TransformedCoordinates:
    """Transform datum points into reference-image frames and propagate the
    bundle covariance (CoordinateTransformationExteriorOrientation.transform,
    :49-121).

    ``object_coordinates``: iterable of ObjectCoordinate (with assigned
    columns into Qxx);
    ``images_to_align``: {reference Image: [source Images]};
    ``Qxx``: bundle cofactor matrix (unscaled), indexed by parameter
    columns: a tensor (the propagation runs on its device) or a numpy
    array (on the CPU).
    """
    Q = torch.as_tensor(Qxx, dtype=torch.float64)
    dev = Q.device

    params_list = []
    cols_list = []
    names = []

    def eo_vals_cols(eo):
        vals = [p.value for p in eo.params]
        cols = [p.column if p.column >= 0 else -1 for p in eo.params]
        return vals, cols

    for ref_image, images in images_to_align.items():
        eo_trg = ref_image.exterior_orientation
        vt, ct = eo_vals_cols(eo_trg)
        for image in images:
            eo_src = image.exterior_orientation
            vs, cs = eo_vals_cols(eo_src)
            for oc in object_coordinates:
                # skip points not visible in the source image (:82-86);
                # the reference-image case needs no special branch: with
                # eo_trg == eo_src the transform is the identity and the EO
                # partials cancel exactly under AD (they share columns)
                if not _image_sees(image, oc):
                    continue
                vals = vt + vs + [oc.x.value, oc.y.value, oc.z.value]
                cols = ct + cs + [
                    oc.x.column if oc.x.column >= 0 else -1,
                    oc.y.column if oc.y.column >= 0 else -1,
                    oc.z.column if oc.z.column >= 0 else -1,
                ]
                params_list.append(vals)
                cols_list.append(cols)
                names.append(f"{oc.name} {image.id} {ref_image.id}")

    if not params_list:
        return TransformedCoordinates(names=[], points=np.zeros((0, 3)),
                                      covariance=np.zeros((0, 0)))

    params = torch.as_tensor(np.asarray(params_list), dtype=torch.float64,
                             device=dev)  # [n, 15]
    cols = torch.as_tensor(np.asarray(cols_list), device=dev)  # [n, 15]

    pts = _transform_batch(params)  # [n, 3]
    J = _jacobian_batch(params)  # [n, 3, 15]
    # zero out columns of fixed parameters (no covariance contribution)
    J = J * (cols >= 0)[:, None, :].to(J.dtype)

    # Sigma(a, b) = sigma^2 * J_a Q[cols_a, cols_b] J_b^T, batched over pairs
    c = torch.where(cols >= 0, cols, 0)
    n = params.shape[0]
    Qg = Q[c[:, None, :, None], c[None, :, None, :]]  # [n, n, 15, 15]
    Sigma = sigma2 * torch.einsum("aij,abjk,blk->aibl", J, Qg,
                                  J).reshape(3 * n, 3 * n)

    return TransformedCoordinates(names=names, points=pts.cpu().numpy(),
                                  covariance=Sigma.cpu().numpy())


def _image_sees(image, oc) -> bool:
    return any(ic.object_coordinate is oc for ic in image)
