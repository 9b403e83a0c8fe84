"""Array-native flat-file loading for the large-scale path (port of
`bundle_adjustment_tpu/io/columnar.py`).

The object-graph readers in `io/readers.py` mirror the reference's
line-by-line readers (survey H3-H13) and build the Python scene graph — the
right tool at metrology scale.  At the target scale (100k..1M points) both
the line loop and the object graph are prohibitive; this module parses the
same formats straight into numpy arrays with the native C++ loader
(`bundle_adjustment_tpu_torch.native`) and assembles the tensor
`RCSProblem` of the feature-major engine without materialising a single
Python scene object.

Format contracts are the reference's flat readers:
  object coords   `name X Y Z [datum]`   ObjectCoordinateFlatFileReader.java:71-96
  image coords    `camId imgId name x y sx sy [rho]`
                                         ImageCoordinateFlatFileReader.java:73-109
  exterior orient `camId imgId X0 Y0 Z0 omega phi kappa`
                                         ExteriorOrientationFlatFileReader.java:69-112
  interior orient `camId x0 y0 c`        InteriorOrientationFlatFileReader.java:66-94
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..native import parse_table


@dataclass
class ObjectPointArrays:
    names: list[str]
    xyz: np.ndarray    # [P, 3] f64
    datum: np.ndarray  # [P] bool


@dataclass
class ImageObservationArrays:
    cam_id: np.ndarray     # [N] int32 (file camera id)
    image_id: np.ndarray   # [N] int32 (file image id)
    point_name_id: np.ndarray  # [N] int32 (index into point_names)
    point_names: list[str]
    xy: np.ndarray         # [N, 2] f64
    sigma: np.ndarray      # [N, 2] f64
    rho: np.ndarray        # [N] f64 (0 where absent)


@dataclass
class ExteriorOrientationArrays:
    cam_id: np.ndarray   # [M] int32
    image_id: np.ndarray  # [M] int32
    eo: np.ndarray        # [M, 6] f64 (X0 Y0 Z0 omega phi kappa)


def load_object_coordinates(path) -> ObjectPointArrays:
    t = parse_table(path, "sfffs")
    ids, names = t.keys[0]
    datum_ids, datum_uniq = t.keys[1]
    # datum flag only when a 5th column equals exactly "1"
    # (ObjectCoordinateFlatFileReader.java:87-90)
    one = datum_uniq.index("1") if "1" in datum_uniq else -2
    keep = (t.ncols >= 4) & ~np.isnan(t.floats).any(axis=1)
    # last occurrence of a name wins (dict overwrite in the reference)
    order = np.flatnonzero(keep)
    last: dict[int, int] = {}
    for r in order:
        last[int(ids[r])] = int(r)
    # first-seen name order, last value wins (dict semantics of the
    # reference's Map<String, ObjectCoordinate>)
    rows_list: list[int] = []
    for r in order:
        row = last.pop(int(ids[r]), None)
        if row is not None:
            rows_list.append(row)
    rows = np.asarray(rows_list, np.int64)
    return ObjectPointArrays(
        names=[names[int(ids[r])] for r in rows],
        xyz=t.floats[rows, :3],
        datum=(datum_ids[rows] == one) & (t.ncols[rows] > 4),
    )


def load_image_coordinates(path) -> ImageObservationArrays:
    t = parse_table(path, "iisfffff")
    name_ids, names = t.keys[0]
    keep = (t.ncols >= 7) & ~np.isnan(t.floats[:, :6]).any(axis=1)
    f = t.floats[keep]
    rho = np.where(np.isnan(f[:, 6]), 0.0, f[:, 6])
    return ImageObservationArrays(
        cam_id=f[:, 0].astype(np.int32),
        image_id=f[:, 1].astype(np.int32),
        point_name_id=name_ids[keep],
        point_names=names,
        xy=np.ascontiguousarray(f[:, 2:4]),
        sigma=np.ascontiguousarray(f[:, 4:6]),
        rho=rho,
    )


def load_exterior_orientations(path) -> ExteriorOrientationArrays:
    t = parse_table(path, "iiffffff")
    keep = (t.ncols >= 8) & ~np.isnan(t.floats).any(axis=1)
    f = t.floats[keep]
    return ExteriorOrientationArrays(
        cam_id=f[:, 0].astype(np.int32),
        image_id=f[:, 1].astype(np.int32),
        eo=np.ascontiguousarray(f[:, 2:8]),
    )


def load_interior_orientation(path) -> np.ndarray:
    """Returns [C, 4]: camId, x0, y0, c (one row per camera id, last wins)."""
    t = parse_table(path, "ifff")
    keep = (t.ncols >= 4) & ~np.isnan(t.floats).any(axis=1)
    f = t.floats[keep]
    out: dict[int, np.ndarray] = {}
    for row in f:
        out[int(row[0])] = row
    return np.stack([out[k] for k in sorted(out)]) if out else np.zeros((0, 4))


def _image_key(cam_id, image_id) -> np.ndarray:
    """One int64 per (camera id, image id) pair."""
    return ((np.asarray(cam_id, np.int64) << 32)
            | (np.asarray(image_id, np.int64) & 0xFFFFFFFF))


def _image_of_observation(eor: ExteriorOrientationArrays,
                          obs: ImageObservationArrays) -> np.ndarray:
    """[N] index of each observation's image among the EO rows, -1 where
    the file has no EO for it; the last EO row of a repeated (camera,
    image) pair wins, as a dict keyed by the pair would."""
    n = obs.cam_id.shape[0]
    M = eor.cam_id.shape[0]
    if M == 0:
        return np.full(n, -1, np.int64)
    keys, first_rev = np.unique(_image_key(eor.cam_id, eor.image_id)[::-1],
                                return_index=True)
    last = M - 1 - first_rev
    want = _image_key(obs.cam_id, obs.image_id)
    pos = np.minimum(np.searchsorted(keys, want), keys.shape[0] - 1)
    return np.where(keys[pos] == want, last[pos], -1)


def build_rcs_problem(points_path, image_coords_path, eor_path,
                      io_path=None, spec=None, dist=None,
                      fix_datum_points: bool = True, device="cuda",
                      dtype=torch.float32, layout: str | None = None):
    """Assemble (RCSProblem, ParamState, spec) of tensors on ``device`` in
    ``dtype`` directly from flat files (CUDA by default; raises without a
    card unless ``device="cpu"``).

    The observations kept and their values are those of the JAX
    `build_rcs_problem`:
    * observations naming an unknown point or an image without an
      exterior orientation are dropped, mirroring the reference readers'
      `if name in coordinates` guards
      (ImageCoordinateFlatFileReader.java:99-104);
    * for a repeated point name the last row wins;
    * points flagged `datum` become fixed coordinates (the scale path's
      minimal-constraint datum; inner Helmert constraints are the dense
      solver's domain);
    * sigma0^2 is the smallest observation variance, clamped to <= 1;
    * r0 = 0 for every camera: the generic interior-orientation file
      carries no distortion reference radius.

    ``layout`` (one of `rcs.LAYOUTS`; None: `rcs.choose_layout` on the
    observations kept):
    * ``"file"``: the JAX function's layout, the observations kept in
      file order (``point_uniform`` None) with the point order and the
      blocked image layout: the block-layout engine's, for a network of
      uneven visibility;
    * ``"point_major"``: the feature-major engine's, observations
      point-major with a uniform V = the most views any point has, each
      point's own observations first in file order, then zero-weight pad
      rows (`rcs.point_major_layout`, the same helper as
      `rcs.rcs_from_problem`), and the blocked image layout.
    """
    from ..models.distortion import DistortionSpecBuilder
    from ..models.problem import ParamState
    from ..ops.residuals import image_weight_2x2
    from ..parallel.rcs import (RCSProblem, check_layout,
                                build_image_block_layout, choose_layout,
                                point_major_layout, point_order)
    from ..solver.adjustment import resolve_device

    dev = resolve_device(device)
    pts = load_object_coordinates(points_path)
    obs = load_image_coordinates(image_coords_path)
    eor = load_exterior_orientations(eor_path)

    # camera table: unique cam ids in EO order
    cam_ids = sorted(set(int(c) for c in eor.cam_id))
    cam_index = {c: i for i, c in enumerate(cam_ids)}
    C = max(1, len(cam_ids))

    # image table: the EO rows in file order
    M = int(eor.cam_id.shape[0])
    cam_of_image = np.array([cam_index[int(c)] for c in eor.cam_id], np.int32)

    # point table: reference file order; one lookup per distinct name
    name_to_pt = {n: i for i, n in enumerate(pts.names)}
    pt_of_name = np.array([name_to_pt.get(n, -1) for n in obs.point_names],
                          np.int64)
    pt_of_obs = pt_of_name[obs.point_name_id]
    img_of_obs = _image_of_observation(eor, obs)
    keep = (pt_of_obs >= 0) & (img_of_obs >= 0)

    P = len(pts.names)
    if spec is None:
        spec = DistortionSpecBuilder().build()
    K = spec.num_coefficients

    io_arr = np.zeros((C, 3))
    if io_path is not None:
        for row in load_interior_orientation(io_path):
            ci = cam_index.get(int(row[0]))
            if ci is not None:
                io_arr[ci] = row[1:4]
    dist_arr = np.zeros((C, K)) if dist is None else np.asarray(dist, float)

    # sigma0^2 = min observation variance clamped to <= 1
    # (BundleAdjustment.java:637-643)
    var = obs.sigma[keep] ** 2
    sigma2 = min(1.0, float(var.min())) if var.size else 1.0

    if layout is None:
        layout = choose_layout(pt_of_obs[keep], P)
    check_layout(layout)
    if layout == "file":
        obs_point = pt_of_obs[keep]
        obs_image = img_of_obs[keep].astype(np.int32)
        xy, rho = obs.xy[keep], obs.rho[keep]
        var = torch.as_tensor(var)
        live = None
        order, counts = point_order(obs_point, P)
        extra = dict(point_uniform=None,
                     point_order=torch.as_tensor(order, device=dev),
                     point_counts=torch.as_tensor(counts, device=dev))
    else:
        pm = point_major_layout(pt_of_obs[keep], P)
        obs_point = np.repeat(np.arange(P), pm.views)
        obs_image = pm.gather(img_of_obs[keep], 0).astype(np.int32)
        xy = pm.gather(obs.xy[keep], 0.0)
        rho = pm.gather(obs.rho[keep], 0.0)
        var = torch.as_tensor(pm.gather(var, 1.0))
        live = torch.as_tensor(pm.live, dtype=torch.float64)
        extra = dict(point_uniform=pm.views)
    # the weights in float64, then in dtype; + 0.0 turns the -0.0 of an
    # uncorrelated point's off-diagonal into +0.0
    w2 = image_weight_2x2(var[:, 0], var[:, 1], torch.as_tensor(rho), sigma2)
    if live is not None:
        w2 = w2 * live[:, None, None]
    w2 = w2 + 0.0

    free_point = np.ones((P, 3))
    if fix_datum_points:
        free_point[pts.datum] = 0.0
    img_perm, img_bstarts = build_image_block_layout(obs_image, M)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    def flt(a):
        return torch.as_tensor(a, dtype=torch.float64).to(dev, dtype)

    problem = RCSProblem(
        obs_point=idx(obs_point), obs_image=idx(obs_image),
        obs_xy=flt(xy), obs_weight=flt(w2), r0=flt(np.zeros(C)),
        num_points=P, num_images=M,
        free_point=flt(free_point), free_eo=flt(np.ones((M, 6))),
        free_global=flt(np.ones(C * (3 + K))),
        img_perm=idx(img_perm), img_block_starts=idx(img_bstarts),
        cam_of_image=idx(cam_of_image), **extra)
    state = ParamState(points=flt(pts.xyz), io=flt(io_arr),
                       dist=flt(dist_arr), eo=flt(eor.eo))
    return problem, state, spec
