"""Estimable parameter state and the compiled array description of a
bundle-adjustment problem (port of `bundle_adjustment_tpu/models/problem.py`).

``compile_problem`` flattens the object graph (models/scene.py) into the
index-based description: static int index arrays + parameter blocks, all
host numpy arrays.  The solver carries the state into a :class:`ParamState`
of tensors on its device and dtype; the (host, numpy) metadata stays in
:class:`BundleProblem`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from .distortion import DistortionSpec, union_specs
from .layout import Layout, assign_columns
from .scene import (
    Camera,
    DirectlyObservedParameterGroup,
    ObjectCoordinate,
    Parameter,
    ScaleBar,
)


class ParamState(NamedTuple):
    """All estimable values, block-structured (tensors on one device; host
    numpy arrays straight out of `compile_problem`)."""

    points: torch.Tensor  # [P, 3]
    io: torch.Tensor      # [C, 3] (x0, y0, c)
    dist: torch.Tensor    # [C, K] spec slot order
    eo: torch.Tensor      # [M, 6] (X0, Y0, Z0, omega, phi, kappa)


def _host(a) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass
class DirectGroupArrays:
    """One directly-observed parameter group, flattened.

    ``kind``: 0 = points, 1 = io, 2 = dist, 3 = eo;
    ``flat``: index into the flattened block array;
    ``col``:  global column (already +d shifted) or -1;
    ``weight``: precomputed P = sigma0^2 * D^{-1} (full) or diagonal.
    """

    kind: np.ndarray  # [n] int32
    flat: np.ndarray  # [n] int32
    col: np.ndarray  # [n] int32
    values: np.ndarray  # [n] f64 observed values
    weight: np.ndarray  # [n, n] f64
    diagonal: bool


@dataclass
class BundleProblem:
    """Host-side static description (numpy); device copies are made by the
    solver once per estimation."""

    spec: DistortionSpec
    num_points: int
    num_cameras: int
    num_images: int
    num_image_obs: int
    num_scale_bars: int

    # observations
    obs_point: np.ndarray  # [N] int32
    obs_image: np.ndarray  # [N] int32
    obs_xy: np.ndarray  # [N, 2]
    obs_var: np.ndarray  # [N, 2]
    obs_rho: np.ndarray  # [N]
    cam_of_image: np.ndarray  # [M] int32
    r0: np.ndarray  # [C]

    # column maps (+d shifted; -1 = fixed/absent)
    col_points: np.ndarray  # [P, 3] int32
    col_io: np.ndarray  # [C, 3] int32
    col_dist: np.ndarray  # [C, K] int32
    col_eo: np.ndarray  # [M, 6] int32

    # scale bars
    sb_a: np.ndarray  # [S] int32
    sb_b: np.ndarray  # [S] int32
    sb_length: np.ndarray  # [S]
    sb_var: np.ndarray  # [S]

    direct_groups: list[DirectGroupArrays]

    # datum
    datum_mask: np.ndarray  # [P] bool: datum & fully free
    defect_flags: tuple[bool, bool, bool, bool, bool, bool, bool]
    defect: int
    num_unknowns: int
    num_observation_rows: int
    num_io_free: int
    num_dist_free: int
    sigma2_apriori: float

    # centroiding masks: which point components / eo position components are
    # free (only free CAMERA/OBJECT coordinates are centroided)
    free_points: np.ndarray = None  # [P, 3] bool
    free_eo_pos: np.ndarray = None  # [M, 3] bool

    @property
    def total_size(self) -> int:
        """Size of the bordered normal-equation system (u + d)."""
        return self.num_unknowns + self.defect

    @property
    def reduced_size(self) -> int:
        """Leading block retained by the EO Schur reduction:
        d + 3 * #object points + free IO + free distortion."""
        return (self.num_io_free + self.num_dist_free
                + 3 * self.num_points + self.defect)

    @property
    def dof(self) -> int:
        return self.num_observation_rows - self.num_unknowns + self.defect


@dataclass
class CompiledScene:
    problem: BundleProblem
    state: ParamState
    layout: Layout
    # write-back handles: (block, flat_index, Parameter)
    handles: list[tuple[str, int, Parameter]] = field(default_factory=list)
    object_coordinates: list[ObjectCoordinate] = field(default_factory=list)

    def write_back(self, state: ParamState) -> None:
        """Parameter values <- state (one host copy of each block)."""
        blocks = {name: _host(getattr(state, name)).ravel()
                  for name in ("points", "io", "dist", "eo")}
        for block, flat, param in self.handles:
            param.value = float(blocks[block][flat])


_KIND_OF_BLOCK = {"points": 0, "io": 1, "dist": 2, "eo": 3}


def compile_problem(cameras: list[Camera], scale_bars: list[ScaleBar],
                    direct_groups: list[DirectlyObservedParameterGroup],
                    layout: Optional[Layout] = None) -> CompiledScene:
    if layout is None:
        layout = assign_columns(cameras, scale_bars, direct_groups)

    spec = union_specs([cam.build_spec() for cam in cameras])
    K = spec.num_coefficients

    # --- index spaces
    coords = layout.object_coordinates
    for i, oc in enumerate(coords):
        oc.index = i
    P = len(coords)

    for ci, cam in enumerate(cameras):
        cam.index = ci
    C = len(cameras)

    images = []
    for cam in cameras:
        for img in cam:
            img.index = len(images)
            images.append(img)
    M = len(images)

    # --- parameter blocks + column maps + write-back handles
    points = np.zeros((P, 3))
    col_points = np.full((P, 3), -1, np.int32)
    io = np.zeros((C, 3))
    col_io = np.full((C, 3), -1, np.int32)
    dist = np.zeros((C, K))
    col_dist = np.full((C, K), -1, np.int32)
    eo = np.zeros((M, 6))
    col_eo = np.full((M, 6), -1, np.int32)
    r0 = np.zeros(C)
    cam_of_image = np.zeros(M, np.int32)

    handles: list[tuple[str, int, Parameter]] = []
    param_location: dict[int, tuple[str, int]] = {}

    def place(block: str, arr, cols, idx, param: Parameter):
        arr.flat[idx] = param.value
        cols.flat[idx] = param.column if param.column >= 0 else -1
        handles.append((block, idx, param))
        param_location[id(param)] = (block, idx)

    for oc in coords:
        base = oc.index * 3
        for k, p in enumerate(oc.params):
            place("points", points, col_points, base + k, p)

    for cam in cameras:
        ci = cam.index
        r0[ci] = cam.r0
        for k, p in enumerate(cam.interior_orientation.params):
            place("io", io, col_io, ci * 3 + k, p)
        for kind in sorted(cam.distortion_models.keys()):
            for key, p in cam.distortion_models[kind].coefficients:
                slot = spec.slot_index(kind, key)
                place("dist", dist, col_dist, ci * K + slot, p)
        for img in cam:
            mi = img.index
            cam_of_image[mi] = ci
            for k, p in enumerate(img.exterior_orientation.params):
                place("eo", eo, col_eo, mi * 6 + k, p)

    # --- image observations (traversal order = row order)
    obs_point, obs_image, obs_xy, obs_var, obs_rho = [], [], [], [], []
    for cam in cameras:
        for img in cam:
            for ic in img:
                obs_point.append(ic.object_coordinate.index)
                obs_image.append(img.index)
                obs_xy.append((ic.x, ic.y))
                obs_var.append((ic.var_x, ic.var_y))
                obs_rho.append(ic.rho)
    N = len(obs_point)

    # --- scale bars
    sb_a = np.array([sb.coordinate_a.index for sb in scale_bars], np.int32)
    sb_b = np.array([sb.coordinate_b.index for sb in scale_bars], np.int32)
    sb_length = np.array([sb.length for sb in scale_bars])
    sb_var = np.array([sb.variance for sb in scale_bars])

    # --- direct groups
    dgs: list[DirectGroupArrays] = []
    for group in direct_groups:
        kind, flat, col, values = [], [], [], []
        for obs in group.observations:
            loc = param_location.get(id(obs.parameter))
            if loc is None:
                raise ValueError(
                    "directly observed parameter is not part of the scene")
            block, idx = loc
            kind.append(_KIND_OF_BLOCK[block])
            flat.append(idx)
            col.append(obs.parameter.column if obs.parameter.column >= 0 else -1)
            values.append(obs.value)
        W = group.weight_matrix(layout.sigma2_apriori)
        dgs.append(DirectGroupArrays(
            kind=np.array(kind, np.int32), flat=np.array(flat, np.int32),
            col=np.array(col, np.int32), values=np.array(values),
            weight=np.asarray(W), diagonal=not group.has_full_dispersion,
        ))

    # --- datum mask: datum flag & all three columns assigned
    datum_mask = np.array(
        [oc.datum and all(p.column >= 0 for p in oc.params) for oc in coords],
        bool,
    )

    rd = layout.defect
    free_points = col_points >= 0
    free_eo_pos = col_eo[:, :3] >= 0

    problem = BundleProblem(
        spec=spec,
        num_points=P, num_cameras=C, num_images=M,
        num_image_obs=N, num_scale_bars=len(scale_bars),
        obs_point=np.array(obs_point, np.int32),
        obs_image=np.array(obs_image, np.int32),
        obs_xy=np.array(obs_xy).reshape(N, 2),
        obs_var=np.array(obs_var).reshape(N, 2),
        obs_rho=np.array(obs_rho),
        cam_of_image=cam_of_image, r0=r0,
        col_points=col_points, col_io=col_io, col_dist=col_dist, col_eo=col_eo,
        sb_a=sb_a, sb_b=sb_b, sb_length=sb_length, sb_var=sb_var,
        direct_groups=dgs,
        datum_mask=datum_mask,
        defect_flags=(rd.translation_x, rd.translation_y, rd.translation_z,
                      rd.rotation_x, rd.rotation_y, rd.rotation_z, rd.scale),
        defect=rd.defect,
        num_unknowns=layout.num_unknowns,
        num_observation_rows=layout.num_observations,
        num_io_free=layout.num_interior_orientation,
        num_dist_free=layout.num_distortion,
        sigma2_apriori=min(layout.sigma2_apriori, 1.0)
        if layout.sigma2_apriori > 0 else 1.0,
        free_points=free_points,
        free_eo_pos=free_eo_pos,
    )
    state = ParamState(points=points, io=io, dist=dist, eo=eo)
    return CompiledScene(problem=problem, state=state, layout=layout,
                         handles=handles, object_coordinates=coords)
