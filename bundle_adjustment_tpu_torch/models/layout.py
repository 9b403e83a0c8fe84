"""Row/column layout and rank-defect analysis.

Faithful port of the reference's deterministic parameter numbering
(`BundleAdjustment.prepareUnknownParameters`, BundleAdjustment.java:667-782)
and free-network rank-defect heuristics (`detectRankDefect`, :836-1042;
`defect/RankDefect.java`).

Column order: object XYZ in image-encounter order -> IO per camera ->
distortion per camera (types sorted, coefficients in insertion order) ->
EO per image -> scale-bar-only points -> directly observed parameters; all
columns then shifted by +d where d is the datum-condition count, so the
bordered constraint block occupies rows/columns 0..d-1.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .scene import (
    Camera,
    DirectlyObservedParameterGroup,
    ObjectCoordinate,
    Parameter,
    ScaleBar,
    UNASSIGNED,
)


@dataclass
class RankDefect:
    """Seven similarity-transform defects; True = free (needs a condition)
    (defect/RankDefect.java:24-143)."""

    translation_x: bool = False
    translation_y: bool = False
    translation_z: bool = False
    rotation_x: bool = False
    rotation_y: bool = False
    rotation_z: bool = False
    scale: bool = False

    @property
    def defect(self) -> int:
        return sum(
            [self.translation_x, self.translation_y, self.translation_z,
             self.rotation_x, self.rotation_y, self.rotation_z, self.scale]
        )

    def none_free(self) -> bool:
        return self.defect == 0


@dataclass
class Layout:
    """Result of the numbering pass."""

    num_observations: int = 0
    num_unknowns: int = 0
    num_interior_orientation: int = 0  # free IO params (for REDUCED block size)
    num_distortion: int = 0  # free distortion params
    defect: RankDefect = field(default_factory=RankDefect)
    unknown_parameters: list[Parameter] = field(default_factory=list)
    object_coordinates: list[ObjectCoordinate] = field(default_factory=list)
    sigma2_apriori: float = 1.0


def _add_unknown(layout: Layout, p: Parameter) -> None:
    """addUnknownParameter: assign next column iff currently unassigned
    (BundleAdjustment.java:651-656)."""
    if p.column == UNASSIGNED:
        p.column = layout.num_unknowns
        layout.num_unknowns += 1
        layout.unknown_parameters.append(p)


def assign_columns(cameras: list[Camera], scale_bars: list[ScaleBar],
                   direct_groups: list[DirectlyObservedParameterGroup]) -> Layout:
    layout = Layout()
    seen_coords: dict[int, ObjectCoordinate] = {}

    def note_coord(oc: ObjectCoordinate):
        if id(oc) not in seen_coords:
            seen_coords[id(oc)] = oc
            layout.object_coordinates.append(oc)

    # sigma0^2 apriori = min over all observation variances, seeded at 1.0
    # (addObservationGroup, BundleAdjustment.java:643-649)
    s2 = 1.0

    # 1. image coordinates: rows + object point columns in encounter order
    for camera in cameras:
        for image in camera:
            for ic in image:
                layout.num_observations += 2
                s2 = min(s2, ic.var_x, ic.var_y)
                oc = ic.object_coordinate
                note_coord(oc)
                _add_unknown(layout, oc.x)
                _add_unknown(layout, oc.y)
                _add_unknown(layout, oc.z)

    # 2. per camera: IO then distortion coefficients
    for camera in cameras:
        for p in camera.interior_orientation.params:
            if p.column == UNASSIGNED:
                layout.num_interior_orientation += 1
            _add_unknown(layout, p)
        for kind in sorted(camera.distortion_models.keys()):
            for _key, p in camera.distortion_models[kind].coefficients:
                if p.column == UNASSIGNED:
                    layout.num_distortion += 1
                _add_unknown(layout, p)

    # 3. per camera, per image: EO
    for camera in cameras:
        for image in camera:
            for p in image.exterior_orientation.params:
                _add_unknown(layout, p)

    # 4. scale bars
    for sb in scale_bars:
        layout.num_observations += 1
        s2 = min(s2, sb.variance)
        for oc in (sb.coordinate_a, sb.coordinate_b):
            note_coord(oc)
            _add_unknown(layout, oc.x)
            _add_unknown(layout, oc.y)
            _add_unknown(layout, oc.z)

    # 5. directly observed parameters
    for group in direct_groups:
        for obs in group.observations:
            if obs.object_coordinate is not None:
                note_coord(obs.object_coordinate)
            _add_unknown(layout, obs.parameter)
            layout.num_observations += 1
            s2 = min(s2, obs.variance)

    layout.sigma2_apriori = s2

    # 6. rank defect + column shift
    layout.defect = detect_rank_defect(cameras, scale_bars, direct_groups,
                                       layout.object_coordinates)
    d = layout.defect.defect
    if d > 0:
        for p in layout.unknown_parameters:
            p.column += d

    return layout


def detect_rank_defect(cameras, scale_bars, direct_groups,
                       object_coordinates) -> RankDefect:
    """Faithful port of BundleAdjustment.detectRankDefect (:836-1042).

    Counting heuristics: any scale bar fixes the scale; known (directly
    observed or held-fixed) coordinate components fix translations; pairs of
    known components fix rotations; >= 6 (with scale bars) or >= 7 known
    components across all axes fix all rotations.
    """
    rd = RankDefect(
        translation_x=True, translation_y=True, translation_z=True,
        rotation_x=True, rotation_y=True, rotation_z=True,
        scale=not scale_bars,
    )
    has_scale_bars = bool(scale_bars)

    count_x = count_y = count_z = 0

    if rd.none_free():
        return rd

    # pass over directly observed rotation angles (:859-880)
    for group in direct_groups:
        for obs in group.observations:
            if obs.param_type == "CAM_OMEGA":
                rd.rotation_x = False
            elif obs.param_type == "CAM_PHI":
                rd.rotation_y = False
            elif obs.param_type == "CAM_KAPPA":
                rd.rotation_z = False
            if not (rd.rotation_x or rd.rotation_y or rd.rotation_z):
                break

    def apply_counting_rules():
        nonlocal count_x, count_y, count_z
        if rd.translation_x and count_x > 0:
            rd.translation_x = False
        if rd.translation_y and count_y > 0:
            rd.translation_y = False
        if rd.translation_z and count_z > 0:
            rd.translation_z = False
        if not has_scale_bars and (count_x >= 2 or count_y >= 2 or count_z >= 2):
            rd.scale = False
        if rd.rotation_x and count_y >= 2 and count_z >= 2:
            rd.rotation_x = False
        if rd.rotation_y and count_x >= 2 and count_z >= 2:
            rd.rotation_y = False
        if rd.rotation_z and count_x >= 2 and count_y >= 2:
            rd.rotation_z = False
        total = count_x + count_y + count_z
        if count_x > 0 and count_y > 0 and count_z > 0 and (
            (has_scale_bars and total >= 6) or (not has_scale_bars and total >= 7)
        ):
            rd.rotation_x = rd.rotation_y = rd.rotation_z = False

    # pass over directly observed coordinates (:882-945)
    done = False
    for group in direct_groups:
        if done:
            break
        for obs in group.observations:
            t = obs.param_type
            if t in ("CAM_X", "OBJ_X"):
                count_x += 1
            elif t in ("CAM_Y", "OBJ_Y"):
                count_y += 1
            elif t in ("CAM_Z", "OBJ_Z"):
                count_z += 1
            elif t == "CAM_OMEGA":
                rd.rotation_x = False
            elif t == "CAM_PHI":
                rd.rotation_y = False
            elif t == "CAM_KAPPA":
                rd.rotation_z = False
            apply_counting_rules()
            if rd.none_free():
                done = True
                break

    # pass over held-fixed object coordinates (:947-995)
    for oc in object_coordinates:
        count_x += 1 if oc.x.fixed else 0
        count_y += 1 if oc.y.fixed else 0
        count_z += 1 if oc.z.fixed else 0
        apply_counting_rules()
        if rd.none_free():
            break

    if rd.none_free():
        return rd

    # pass over held-fixed exterior orientations (:1000-1040)
    for camera in cameras:
        stop = False
        for image in camera:
            eo = image.exterior_orientation
            if rd.rotation_x and eo.omega.fixed:
                rd.rotation_x = False
            if rd.rotation_y and eo.phi.fixed:
                rd.rotation_y = False
            if rd.rotation_z and eo.kappa.fixed:
                rd.rotation_z = False
            count_x += 1 if eo.x0.fixed else 0
            count_y += 1 if eo.y0.fixed else 0
            count_z += 1 if eo.z0.fixed else 0
            apply_counting_rules()
            if rd.none_free():
                stop = True
                break
        if stop:
            break

    return rd
