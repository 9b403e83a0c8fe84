"""Static distortion-model specification.

The reference attaches per-camera distortion model *objects*
(`.../camera/distortion/`, models D1-D7 of the survey).  TPU-first, the
structure must be static: a :class:`DistortionSpec` describes the *layout* of
a camera's distortion coefficient vector — which models are present, which
polynomial orders, which Zernike terms — and the coefficient *values* live in
a flat ``[K]`` array per camera.  Absent models are represented by
zero-valued, fixed coefficients, which makes every camera in a scene share one
static spec (the union of all models) without changing any result.

Slot ordering reproduces the reference's deterministic column order: model
types sorted by enum ordinal (AFFINITY_AND_SHEAR < TANGENTIAL_DISTORTION <
RADIAL_DISTORTION < DISTANCE_DISTORTION < ZERNIKE_X < ZERNIKE_Y <
ZERNIKE_GRADIENT; `camera/Camera.java:51` sorts types, `DistortionModel.java`
Type enum), and insertion order of coefficients within a model
(`PolynomialDistortionModel.java` keeps a LinkedHashMap; the tangential model
inserts Bx, By first — `TangentialDistortionModel.java:30-50`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .zernike import ZernikePolynomial


class DistortionType(enum.IntEnum):
    """Mirrors DistortionModel.Type ordinals (DistortionModel.java:30-40)."""

    AFFINITY_AND_SHEAR = 0
    TANGENTIAL_DISTORTION = 1
    RADIAL_DISTORTION = 2
    DISTANCE_DISTORTION = 3
    ZERNIKE_X = 4
    ZERNIKE_Y = 5
    ZERNIKE_GRADIENT = 6


@dataclass(frozen=True)
class Slot:
    """One coefficient slot in the flat distortion vector.

    ``kind``   — DistortionType of the owning model;
    ``key``    — within-model key: polynomial order (radial/distance/
                 tangential-Bi), -1/-2 for Bx/By, 0/1 for Cx/Cy, or the
                 Fringe index for Zernike terms;
    ``order``  — polynomial order for r^(2*order) terms (0 if n/a).
    """

    kind: DistortionType
    key: int
    order: int = 0


@dataclass(frozen=True)
class DistortionSpec:
    """Static (hashable) layout of the distortion coefficient vector."""

    slots: tuple[Slot, ...] = ()
    # Zernike polynomial data per slot index that is a Zernike term
    # (parallel mapping: slot position -> ZernikePolynomial or None).
    zernike: tuple[ZernikePolynomial | None, ...] = ()

    def __post_init__(self):
        if len(self.zernike) not in (0, len(self.slots)):
            raise ValueError("zernike tuple must be empty or parallel to slots")
        if len(self.zernike) == 0:
            object.__setattr__(self, "zernike", (None,) * len(self.slots))

    @property
    def num_coefficients(self) -> int:
        return len(self.slots)

    def slot_index(self, kind: DistortionType, key: int) -> int:
        for i, s in enumerate(self.slots):
            if s.kind == kind and s.key == key:
                return i
        raise KeyError(f"no slot ({kind!r}, {key})")

    def has(self, kind: DistortionType) -> bool:
        return any(s.kind == kind for s in self.slots)


class DistortionSpecBuilder:
    """Builds a DistortionSpec with reference-identical slot ordering."""

    def __init__(self) -> None:
        # per type: ordered list of (key, order, ZernikePolynomial|None)
        self._models: dict[DistortionType, list[tuple[int, int, ZernikePolynomial | None]]] = {}

    def _model(self, kind: DistortionType) -> list:
        return self._models.setdefault(kind, [])

    def add_affinity(self) -> "DistortionSpecBuilder":
        m = self._model(DistortionType.AFFINITY_AND_SHEAR)
        if not m:
            m.extend([(0, 0, None), (1, 0, None)])  # Cx, Cy
        return self

    def add_tangential(self) -> "DistortionSpecBuilder":
        m = self._model(DistortionType.TANGENTIAL_DISTORTION)
        if not m:
            m.extend([(-1, 0, None), (-2, 0, None)])  # Bx, By (created fixed)
        return self

    def add_tangential_order(self, order: int) -> "DistortionSpecBuilder":
        if order <= 0:
            raise ValueError("polynomial coefficient order must be positive")
        self.add_tangential()
        m = self._model(DistortionType.TANGENTIAL_DISTORTION)
        if any(k == order for k, _, _ in m):
            raise ValueError(f"duplicate tangential order {order}")
        m.append((order, order, None))
        return self

    def add_radial_order(self, order: int) -> "DistortionSpecBuilder":
        if order <= 0:
            raise ValueError("polynomial coefficient order must be positive")
        m = self._model(DistortionType.RADIAL_DISTORTION)
        if any(k == order for k, _, _ in m):
            raise ValueError(f"duplicate radial order {order}")
        m.append((order, order, None))
        return self

    def add_distance_order(self, order: int) -> "DistortionSpecBuilder":
        if order <= 0:
            raise ValueError("polynomial coefficient order must be positive")
        m = self._model(DistortionType.DISTANCE_DISTORTION)
        if any(k == order for k, _, _ in m):
            raise ValueError(f"duplicate distance order {order}")
        m.append((order, order, None))
        return self

    def add_zernike(self, kind: DistortionType, fringe_index: int, normalise: bool = True) -> "DistortionSpecBuilder":
        if kind not in (
            DistortionType.ZERNIKE_X,
            DistortionType.ZERNIKE_Y,
            DistortionType.ZERNIKE_GRADIENT,
        ):
            raise ValueError(f"not a Zernike model: {kind!r}")
        m = self._model(kind)
        if any(k == fringe_index for k, _, _ in m):
            raise ValueError(f"duplicate Zernike index {fringe_index}")
        m.append((fringe_index, fringe_index, ZernikePolynomial.from_fringe(fringe_index, normalise)))
        return self

    def build(self) -> DistortionSpec:
        slots: list[Slot] = []
        zern: list[ZernikePolynomial | None] = []
        for kind in sorted(self._models.keys()):
            for key, order, zp in self._models[kind]:
                slots.append(Slot(kind=kind, key=key, order=order))
                zern.append(zp)
        return DistortionSpec(slots=tuple(slots), zernike=tuple(zern))


def union_specs(specs: list[DistortionSpec]) -> DistortionSpec:
    """Union of several cameras' specs (slot-set union, canonical order).

    Cameras whose spec lacks a slot get coefficient 0, fixed — numerically
    identical to the model being absent.
    """
    builder_models: dict[DistortionType, list[tuple[int, int, ZernikePolynomial | None]]] = {}
    for spec in specs:
        for slot, zp in zip(spec.slots, spec.zernike):
            m = builder_models.setdefault(slot.kind, [])
            if not any(k == slot.key for k, _, _ in m):
                m.append((slot.key, slot.order, zp))
    slots: list[Slot] = []
    zern: list[ZernikePolynomial | None] = []
    for kind in sorted(builder_models.keys()):
        for key, order, zp in builder_models[kind]:
            slots.append(Slot(kind=kind, key=key, order=order))
            zern.append(zp)
    return DistortionSpec(slots=tuple(slots), zernike=tuple(zern))
