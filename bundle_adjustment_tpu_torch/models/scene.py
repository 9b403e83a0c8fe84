"""Scene graph and array compilation.

User-facing model objects mirror the reference's graph
(Camera -> Image -> ImageCoordinate -> ObjectCoordinate, ScaleBar,
DirectlyObservedParameterGroup; survey rows C1-C8, B1-B8) but compile into a
static, index-based array description (:class:`BundleProblem`) — the
TPU-native representation: per-observation int index arrays plus parameter
blocks ``points[P,3]``, ``io[C,3]``, ``dist[C,K]``, ``eo[M,6]``.

Fixed parameters (the reference's ``column == Integer.MAX_VALUE`` protocol,
`parameter/UnknownParameter.java:27-53`) become ``column = -2`` here; fresh
unassigned cells are ``column = -1``.  The layout pass
(:meth:`BundleAdjustmentBuilder.assign_columns`) reproduces the reference's
deterministic first-seen ordering (`BundleAdjustment.prepareUnknownParameters`,
BundleAdjustment.java:667-782) so covariance indices match JAICOV's exports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from .distortion import (
    DistortionSpec,
    DistortionSpecBuilder,
    DistortionType,
    Slot,
    union_specs,
)

UNASSIGNED = -1
FIXED = -2


class Parameter:
    """A single scalar parameter cell: value + column protocol."""

    __slots__ = ("value", "column", "name")

    def __init__(self, value: float = 0.0, fixed: bool = False, name: str = ""):
        self.value = float(value)
        self.column = FIXED if fixed else UNASSIGNED
        self.name = name

    @property
    def fixed(self) -> bool:
        return self.column == FIXED

    @fixed.setter
    def fixed(self, v: bool) -> None:
        self.column = FIXED if v else UNASSIGNED

    @property
    def is_assigned(self) -> bool:
        return self.column >= 0

    def __repr__(self):
        return f"Parameter({self.name}={self.value}, col={self.column})"


class ObjectCoordinate:
    """Named 3D object point (ObjectCoordinate.java:33-102); datum defaults
    to True as in the reference (:34)."""

    def __init__(self, name: str, x: float = 0.0, y: float = 0.0, z: float = 0.0):
        self.name = name
        self.x = Parameter(x, name=f"{name}.X")
        self.y = Parameter(y, name=f"{name}.Y")
        self.z = Parameter(z, name=f"{name}.Z")
        self.datum = True
        self.index: int = -1  # assigned at compile

    @property
    def params(self) -> tuple[Parameter, Parameter, Parameter]:
        return (self.x, self.y, self.z)

    def set_datum(self, datum: bool) -> None:
        self.datum = bool(datum)

    def __repr__(self):
        return f"ObjectCoordinate({self.name})"


class InteriorOrientation:
    """x0, y0, c (camera/orientation/InteriorOrientation.java:32-95)."""

    def __init__(self):
        self.x0 = Parameter(0.0, name="x0")
        self.y0 = Parameter(0.0, name="y0")
        self.c = Parameter(0.0, name="c")

    @property
    def params(self):
        # iteration order x0, y0, c matches the reference iterator
        return (self.x0, self.y0, self.c)


class ExteriorOrientation:
    """X0, Y0, Z0, omega, phi, kappa
    (camera/orientation/ExteriorOrientation.java:34-101)."""

    def __init__(self):
        self.x0 = Parameter(0.0, name="X0")
        self.y0 = Parameter(0.0, name="Y0")
        self.z0 = Parameter(0.0, name="Z0")
        self.omega = Parameter(0.0, name="omega")
        self.phi = Parameter(0.0, name="phi")
        self.kappa = Parameter(0.0, name="kappa")

    def set(self, x0, y0, z0, omega, phi, kappa):
        for p, v in zip(self.params, (x0, y0, z0, omega, phi, kappa)):
            p.value = float(v)

    @property
    def params(self):
        return (self.x0, self.y0, self.z0, self.omega, self.phi, self.kappa)


class ImageCoordinate:
    """Two correlated observations (x, y) of an object point in an image
    (camera/ImageCoordinate.java:33-105)."""

    def __init__(self, object_coordinate: ObjectCoordinate, image: "Image",
                 xp: float, yp: float, sigma_x: float, sigma_y: float, rho: float = 0.0):
        if abs(rho) >= 1.0:
            raise ValueError(f"correlation coefficient must be in (-1, 1): {rho}")
        self.object_coordinate = object_coordinate
        self.image = image
        self.x = float(xp)
        self.y = float(yp)
        self.var_x = float(sigma_x) ** 2
        self.var_y = float(sigma_y) ** 2
        self.rho = float(rho)


class Image:
    """Image with exterior orientation and measured image points
    (camera/Image.java:33-89)."""

    def __init__(self, image_id: int, camera: "Camera"):
        self.id = image_id
        self.camera = camera
        self.exterior_orientation = ExteriorOrientation()
        self._coordinates: dict[ObjectCoordinate, ImageCoordinate] = {}
        self.index: int = -1

    @property
    def eo(self) -> ExteriorOrientation:
        return self.exterior_orientation

    def add(self, object_coordinate: ObjectCoordinate, xp, yp, sigma_x, sigma_y, rho=0.0) -> ImageCoordinate:
        ic = ImageCoordinate(object_coordinate, self, xp, yp, sigma_x, sigma_y, rho)
        self._coordinates[object_coordinate] = ic
        return ic

    def __iter__(self):
        return iter(self._coordinates.values())

    def __len__(self):
        return len(self._coordinates)


class DistortionModelHandle:
    """Per-camera handle over one distortion model's coefficient Parameters."""

    def __init__(self, camera: "Camera", kind: DistortionType):
        self.camera = camera
        self.kind = kind
        # ordered (key, Parameter) as inserted
        self.coefficients: list[tuple[int, Parameter]] = []
        if kind == DistortionType.AFFINITY_AND_SHEAR:
            # Cx, Cy created fixed (AffinityShearDistortionModel.java:37-41)
            self.coefficients.append((0, Parameter(0.0, fixed=True, name="Cx")))
            self.coefficients.append((1, Parameter(0.0, fixed=True, name="Cy")))
        elif kind == DistortionType.TANGENTIAL_DISTORTION:
            # Bx, By created fixed (TangentialDistortionModel.java:39-50)
            self.coefficients.append((-1, Parameter(0.0, fixed=True, name="Bx")))
            self.coefficients.append((-2, Parameter(0.0, fixed=True, name="By")))

    def get(self, key: int) -> Parameter:
        for k, p in self.coefficients:
            if k == key:
                return p
        raise KeyError(f"no coefficient {key} in {self.kind!r}")

    @property
    def cx(self) -> Parameter:
        return self.get(0)

    @property
    def cy(self) -> Parameter:
        return self.get(1)

    @property
    def bx(self) -> Parameter:
        return self.get(-1)

    @property
    def by(self) -> Parameter:
        return self.get(-2)

    def add(self, order: int, value: float = 0.0) -> Parameter:
        """Add a polynomial coefficient (A_i / B_i / D_i) or Zernike term by
        Fringe index; returns its Parameter."""
        if self.kind in (
            DistortionType.RADIAL_DISTORTION,
            DistortionType.DISTANCE_DISTORTION,
            DistortionType.TANGENTIAL_DISTORTION,
        ):
            if order <= 0:
                raise ValueError("polynomial coefficient order must be positive")
        if any(k == order for k, _ in self.coefficients):
            raise ValueError(f"duplicate coefficient order {order}")
        p = Parameter(value, name=f"{self.kind.name}({order})")
        self.coefficients.append((order, p))
        return p

    def __iter__(self):
        return iter(p for _, p in self.coefficients)


class Camera:
    """Camera with interior orientation and a sorted set of distortion models
    (camera/Camera.java:40-133)."""

    def __init__(self, camera_id: int, r0: float = 0.0,
                 distortion_types: Iterable[DistortionType] = ()):
        self.id = camera_id
        self.r0 = float(r0)
        self.interior_orientation = InteriorOrientation()
        types = sorted(set(distortion_types))
        self.distortion_models: dict[DistortionType, DistortionModelHandle] = {
            t: DistortionModelHandle(self, t) for t in types
        }
        self._images: dict[int, Image] = {}
        self.index: int = -1

    @property
    def io(self) -> InteriorOrientation:
        return self.interior_orientation

    def distortion(self, kind: DistortionType) -> DistortionModelHandle:
        return self.distortion_models[kind]

    def add_image(self, image_id: int) -> Image:
        if image_id in self._images:
            return self._images[image_id]
        img = Image(image_id, self)
        self._images[image_id] = img
        return img

    # alias matching the reference API
    add = add_image

    def __iter__(self):
        return iter(self._images.values())

    @property
    def images(self) -> list[Image]:
        return list(self._images.values())

    def build_spec(self) -> DistortionSpec:
        """This camera's own distortion layout (sorted types, insertion order
        within model) — identical ordering to Camera.getDistortionModels()."""
        from .zernike import ZernikePolynomial

        slots = []
        zern = []
        for kind in sorted(self.distortion_models.keys()):
            for key, _p in self.distortion_models[kind].coefficients:
                order = max(key, 0)
                zp = None
                if kind in (DistortionType.ZERNIKE_X, DistortionType.ZERNIKE_Y,
                            DistortionType.ZERNIKE_GRADIENT):
                    zp = ZernikePolynomial.from_fringe(key)
                slots.append(Slot(kind=kind, key=key, order=order))
                zern.append(zp)
        return DistortionSpec(slots=tuple(slots), zernike=tuple(zern))


class ScaleBar:
    """Observed distance between two object points (ScaleBar.java:31-83)."""

    def __init__(self, coordinate_a: ObjectCoordinate, coordinate_b: ObjectCoordinate,
                 length: float, sigma: float):
        self.coordinate_a = coordinate_a
        self.coordinate_b = coordinate_b
        self.length = float(length)
        self.variance = float(sigma) ** 2


@dataclass
class DirectObservation:
    """One pseudo-observation of an unknown parameter
    (parameter/ObservationParameter.java:27-64)."""

    parameter: Parameter
    value: float
    variance: float = 1.0
    # parameter classification for rank-defect detection and centroiding
    # (one of: 'OBJ_X','OBJ_Y','OBJ_Z','CAM_X','CAM_Y','CAM_Z',
    #  'CAM_OMEGA','CAM_PHI','CAM_KAPPA','OTHER')
    param_type: str = "OTHER"
    # owning object coordinate, if the parameter is an object coordinate
    object_coordinate: Optional[ObjectCoordinate] = None


class DirectlyObservedParameterGroup:
    """Group of direct observations with optional fully populated dispersion
    (parameter/DirectlyObservedParameterGroup.java:37-102)."""

    def __init__(self, observations: list[DirectObservation],
                 dispersion: Optional[np.ndarray] = None):
        self.observations = list(observations)
        self.dispersion = None
        if dispersion is not None:
            dispersion = np.asarray(dispersion, dtype=np.float64)
            n = len(self.observations)
            if dispersion.shape != (n, n):
                raise ValueError(
                    f"dispersion shape {dispersion.shape} != ({n}, {n})")
            # variances from the dispersion diagonal (reference ctor :56-58)
            for i, obs in enumerate(self.observations):
                obs.variance = float(dispersion[i, i])
            self.dispersion = dispersion

    @property
    def has_full_dispersion(self) -> bool:
        return self.dispersion is not None

    def weight_matrix(self, sigma2_apriori: float) -> np.ndarray:
        """P = sigma0^2 * D^{-1} (full) or diag(sigma0^2 / var) — the weight
        the reference lazily computes (DirectlyObservedParameterGroup.java:67-92)."""
        if self.has_full_dispersion:
            return sigma2_apriori * np.linalg.inv(self.dispersion)
        return np.diag([sigma2_apriori / o.variance for o in self.observations])
