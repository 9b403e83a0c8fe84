"""Host arrays -> the port's tensors on a device, and scenes -> the port's
scene objects.

`problem_to_torch` / `state_to_torch` take an RCSProblem-shaped object whose
fields are host arrays (the port's `synthetic.build_problem`, or the JAX
package's `bench.build_problem`) and a ParamState-shaped object, and return
the port's tensor containers on the given device: index arrays as int32,
everything else in ``dtype``.  `scene_from` rebuilds a scene graph of any
objects with the reference's attribute names as the port's own
`models.scene` objects.  The tests use both to feed the two
implementations the same problem.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .models import scene as S
from .models.problem import ParamState
from .parallel.rcs import RCSProblem

_INDEX_FIELDS = ("obs_point", "obs_image", "img_perm", "img_block_starts")
_FLOAT_FIELDS = ("obs_xy", "obs_weight", "r0", "free_point", "free_eo",
                 "free_global")
# optional fields (None = absent): the camera of each image (absent: one
# camera), scale bars, Helmert datum, direct observations (see
# parallel/rcs.RCSProblem)
_OPT_INDEX_FIELDS = ("cam_of_image", "sb_a", "sb_b", "dpg_idx",
                     "dpg_axis")
_OPT_FLOAT_FIELDS = ("sb_length", "sb_weight", "datum_mask_d", "dp_w",
                     "dp_val", "de_w", "de_val", "dg_w", "dg_val", "dpg_val",
                     "dpg_cov")
# fields of the JAX RCSProblem the port does not take: the dense
# visibility tables of the block-layout engine
_UNSUPPORTED = ("point2obs", "img2obs")


def refuse_unsupported(problem) -> None:
    """Raise NotImplementedError for a problem with the block-layout
    engine's visibility tables."""
    for name in _UNSUPPORTED:
        if getattr(problem, name, None) is not None:
            raise NotImplementedError(
                f"RCSProblem.{name} is not supported by the port yet")


def problem_to_torch(problem, device, dtype=torch.float32) -> RCSProblem:
    """The port's RCSProblem with tensors on ``device``."""
    refuse_unsupported(problem)

    def idx(a):
        return torch.as_tensor(np.array(a, np.int32), device=device)

    def flt(a):
        return torch.as_tensor(np.array(a, np.float64), device=device,
                               dtype=dtype)

    def opt(conv, name):
        a = getattr(problem, name, None)
        return None if a is None else conv(a)

    fields = {n: idx(getattr(problem, n)) for n in _INDEX_FIELDS}
    fields.update({n: flt(getattr(problem, n)) for n in _FLOAT_FIELDS})
    fields.update({n: opt(idx, n) for n in _OPT_INDEX_FIELDS})
    fields.update({n: opt(flt, n) for n in _OPT_FLOAT_FIELDS})
    flags = getattr(problem, "defect_flags_d", None)
    return RCSProblem(num_points=int(problem.num_points),
                      num_images=int(problem.num_images),
                      point_uniform=problem.point_uniform,
                      defect_flags_d=None if flags is None
                      else tuple(bool(f) for f in flags), **fields)


def state_to_torch(state, device, dtype=torch.float32) -> ParamState:
    """The port's ParamState with tensors on ``device``."""
    return ParamState(*(torch.as_tensor(np.array(a, np.float64),
                                        device=device, dtype=dtype)
                        for a in state))


class Scene(NamedTuple):
    """The port's scene objects of `scene_from`."""

    cameras: list
    scale_bars: list
    direct_groups: list
    # source object (ObjectCoordinate or Parameter) -> the port's
    coordinates: dict
    parameters: dict


def scene_from(cameras, scale_bars=(), direct_groups=()) -> Scene:
    """Rebuild a scene as the port's `models.scene` objects from objects
    with the reference's attribute names (duck-typed: the JAX package's
    scene classes, or any others shaped like them).

    Carried across: camera ids, r0, distortion models with their
    coefficients in insertion order; every parameter's value and ``fixed``
    flag (IO, distortion, EO, object coordinates); datum flags; images in
    order with their image points (values, variances and rho as stored);
    scale bars (variance as stored); direct groups with their observations
    (value, variance, parameter type) and dispersion."""
    params: dict = {}
    coords: dict = {}

    def param(src, dst):
        dst.value = float(src.value)
        dst.fixed = bool(src.fixed)
        params[src] = dst
        return dst

    def coord(src):
        if src not in coords:
            oc = S.ObjectCoordinate(src.name)
            for a in ("x", "y", "z"):
                param(getattr(src, a), getattr(oc, a))
            oc.set_datum(src.datum)
            coords[src] = oc
        return coords[src]

    cams = []
    for cam in cameras:
        out = S.Camera(cam.id, r0=cam.r0, distortion_types=tuple(
            S.DistortionType(int(k)) for k in cam.distortion_models))
        for a in ("x0", "y0", "c"):
            param(getattr(cam.interior_orientation, a),
                  getattr(out.interior_orientation, a))
        for kind, handle in cam.distortion_models.items():
            dst = out.distortion(S.DistortionType(int(kind)))
            have = {k for k, _ in dst.coefficients}
            for key, p in handle.coefficients:
                param(p, dst.get(key) if key in have else dst.add(key))
        for img in cam:
            oi = out.add_image(img.id)
            for a in ("x0", "y0", "z0", "omega", "phi", "kappa"):
                param(getattr(img.exterior_orientation, a),
                      getattr(oi.exterior_orientation, a))
            for ic in img:
                o = oi.add(coord(ic.object_coordinate), ic.x, ic.y, 1.0, 1.0,
                           ic.rho)
                o.var_x, o.var_y = float(ic.var_x), float(ic.var_y)
        cams.append(out)

    bars = []
    for sb in scale_bars:
        bar = S.ScaleBar(coord(sb.coordinate_a), coord(sb.coordinate_b),
                         sb.length, 1.0)
        bar.variance = float(sb.variance)
        bars.append(bar)

    groups = []
    for g in direct_groups:
        obs = []
        for o in g.observations:
            if o.object_coordinate is not None:
                coord(o.object_coordinate)
            target = params.get(o.parameter)
            if target is None:  # a parameter outside the scene
                target = param(o.parameter, S.Parameter(name=o.parameter.name))
            obs.append(S.DirectObservation(
                parameter=target, value=float(o.value),
                variance=float(o.variance), param_type=o.param_type,
                object_coordinate=None if o.object_coordinate is None
                else coords[o.object_coordinate]))
        groups.append(S.DirectlyObservedParameterGroup(
            obs, None if g.dispersion is None else np.array(g.dispersion)))
    return Scene(cams, bars, groups, coords, params)


def point_shard(state, comm, dtype=torch.float64):
    """A state gathered on the host (e.g. the JAX point-sharded step's
    (points, io, dist, eo)) -> this rank's arguments of the port's
    `spmd_fm` step: its P / D points and the replicated io, dist, eo, on
    ``comm.device``."""
    points, io, dist, eo = (np.array(a, np.float64) for a in state)
    n = points.shape[0] // comm.size
    if n * comm.size != points.shape[0]:
        raise ValueError(f"{points.shape[0]} points do not split over "
                         f"{comm.size} ranks (pad_for_mesh)")

    def t(a):
        return torch.as_tensor(a, device=comm.device, dtype=dtype)

    return (t(points[comm.rank * n:(comm.rank + 1) * n]), t(io), t(dist),
            t(eo))


def scenario_batch_from(batch, device, dtype=torch.float64):
    """A scenario batch of host-readable arrays shaped like the JAX
    `ScenarioBatch` (problem, obs_xy [S, N, 2], obs_weight [S, N, 2, 2],
    states with a leading S) -> the port's `scenario.ScenarioBatch` on
    ``device``.  A problem in file order (no ``point_uniform``; the block
    layout's visibility tables are dropped) is re-laid point-major by
    `rcs.point_major_layout`, its pad entries weighted zero."""
    from .parallel import rcs, scenario

    p = batch.problem
    P, M = int(p.num_points), int(p.num_images)
    obs_point = np.asarray(p.obs_point, np.int64)
    xy = np.asarray(batch.obs_xy, np.float64)
    w = np.asarray(batch.obs_weight, np.float64)
    if p.point_uniform is not None:
        V = int(p.point_uniform)
        obs_image = np.asarray(p.obs_image, np.int32)
    else:
        pm = rcs.point_major_layout(obs_point, P)
        V = pm.views
        obs_image = pm.gather(p.obs_image, 0).astype(np.int32)
        xy = np.stack([pm.gather(a, 0.0) for a in xy])
        live = pm.live.astype(np.float64)[:, None, None]
        w = np.stack([pm.gather(a, 0.0) * live for a in w])
    img_perm, img_bstarts = rcs.build_image_block_layout(obs_image, M)
    cam = getattr(p, "cam_of_image", None)
    host = rcs.RCSProblem(
        obs_point=np.repeat(np.arange(P, dtype=np.int32), V),
        obs_image=obs_image, obs_xy=xy[0], obs_weight=w[0],
        r0=np.asarray(p.r0), num_points=P, num_images=M,
        free_point=np.asarray(p.free_point), free_eo=np.asarray(p.free_eo),
        free_global=np.asarray(p.free_global), img_perm=img_perm,
        img_block_starts=img_bstarts, point_uniform=V,
        cam_of_image=None if cam is None else np.asarray(cam))
    return scenario.make_batch(
        problem_to_torch(host, device, dtype), xy, w,
        ParamState(*(np.asarray(a, np.float64) for a in batch.states)))
