"""File readers: generic whitespace-column flat files and AICON 3D Studio
formats, including the HTML adjustment-report parser (port of
`bundle_adjustment_tpu/io/readers.py` onto the port's scene model).

Ports of the reference reader stack (`util/io/reader/`, survey rows H1-H13):
line-based parsing with BOM handling and comment-prefix skipping
(LockFileReader.java:69-103), five flat-file readers and the six AICON
readers (`reader/aicon/`).  Parse-error lines are skipped, matching the
reference's catch-and-continue behaviour.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterable, Optional

from ..models.distortion import DistortionType
from ..models.scene import Camera, Image, ObjectCoordinate, ScaleBar


class ReadInterrupt:
    """Cooperative interrupt flag for long reads: `interrupt()` from another
    thread stops the line loop at the next line, mirroring the reference's
    `this.interrupt` check inside the read loop (LockFileReader.java:105-107,
    checked at :84)."""

    def __init__(self) -> None:
        self._flag = False

    def interrupt(self) -> None:
        self._flag = True

    def __bool__(self) -> bool:
        return self._flag


def _read_lines(path, ignore_prefix: Optional[str] = None,
                interrupt: Optional[ReadInterrupt] = None) -> Iterable[str]:
    """BOM-aware line iterator skipping blank and comment lines, holding a
    shared advisory lock for the duration of the read and honouring a
    cooperative interrupt (LockFileReader.java:69-111: FileLock at :80,
    interrupt check at :84/:105-107)."""
    with open(path, "r", encoding="utf-8-sig", errors="replace") as fh:
        locked = False
        try:
            import fcntl

            fcntl.flock(fh.fileno(), fcntl.LOCK_SH)
            locked = True
        except (ImportError, OSError):  # non-POSIX or unlockable stream
            pass
        try:
            for line in fh:
                if interrupt:
                    return
                line = line.rstrip("\n").rstrip("\r")
                if not line.strip():
                    continue
                if ignore_prefix and line.strip().startswith(ignore_prefix):
                    continue
                yield line
        finally:
            if locked:
                import fcntl

                fcntl.flock(fh.fileno(), fcntl.LOCK_UN)


# --------------------------------------------------------------------------
# generic flat-file readers (H3-H7)
# --------------------------------------------------------------------------

def read_object_coordinates_flat(path, interrupt=None) -> dict[str, ObjectCoordinate]:
    """`name X Y Z [datum]` (ObjectCoordinateFlatFileReader.java:71-96);
    datum only if the 5th column is exactly "1"."""
    out: dict[str, ObjectCoordinate] = {}
    for line in _read_lines(path, "#", interrupt):
        cols = line.split()
        if len(cols) < 4:
            continue
        try:
            name = cols[0]
            x, y, z = (float(c) for c in cols[1:4])
        except ValueError:
            continue
        oc = ObjectCoordinate(name, x, y, z)
        oc.set_datum(len(cols) > 4 and cols[4] == "1")
        out[name] = oc
    return out


def read_image_coordinates_flat(path, camera: Camera,
                                coordinates: dict[str, ObjectCoordinate],
                                interrupt=None) -> Camera:
    """`camId imgId name x y sx sy [rho]`
    (ImageCoordinateFlatFileReader.java:73-109)."""
    for line in _read_lines(path, "#", interrupt):
        cols = line.split()
        if len(cols) < 7:
            continue
        try:
            if int(cols[0]) != camera.id:
                continue
            imgid = int(cols[1])
            name = cols[2]
            xp, yp, sx, sy = (float(c) for c in cols[3:7])
            rho = float(cols[7]) if len(cols) > 7 else 0.0
        except ValueError:
            continue
        image = camera.add_image(imgid)
        if name in coordinates:
            image.add(coordinates[name], xp, yp, sx, sy, rho)
    return camera


def read_exterior_orientations_flat(path, camera: Camera, interrupt=None) -> Camera:
    """`camId imgId X0 Y0 Z0 omega phi kappa`
    (ExteriorOrientationFlatFileReader.java:69-112)."""
    for line in _read_lines(path, "#", interrupt):
        cols = line.split()
        if len(cols) < 8:
            continue
        try:
            if int(cols[0]) != camera.id:
                continue
            imgid = int(cols[1])
            vals = [float(c) for c in cols[2:8]]
        except ValueError:
            continue
        camera.add_image(imgid).eo.set(*vals)
    return camera


def read_interior_orientation_flat(path, camera: Camera, interrupt=None) -> Camera:
    """`camId x0 y0 c` (InteriorOrientationFlatFileReader.java:66-94)."""
    for line in _read_lines(path, "#", interrupt):
        cols = line.split()
        if len(cols) < 4:
            continue
        try:
            if int(cols[0]) != camera.id:
                raise ValueError(
                    f"camera-id mismatch: {camera.id} vs. {cols[0]}")
            x0, y0, c = (float(v) for v in cols[1:4])
        except ValueError:
            continue
        camera.io.x0.value = x0
        camera.io.y0.value = y0
        camera.io.c.value = c
    return camera


def read_scale_bars_flat(path, coordinates: dict[str, ObjectCoordinate],
                         interrupt=None) -> list[ScaleBar]:
    """`nameA nameB length sigma` (ScaleBarFlatFileReader.java:76-104)."""
    out = []
    for line in _read_lines(path, "#", interrupt):
        cols = line.split()
        if len(cols) < 4:
            continue
        a, b = cols[0], cols[1]
        if a not in coordinates or b not in coordinates:
            continue
        try:
            length, sigma = float(cols[2]), float(cols[3])
        except ValueError:
            continue
        out.append(ScaleBar(coordinates[a], coordinates[b], length, sigma))
    return out


# --------------------------------------------------------------------------
# AICON 3D Studio file formats (H9-H13)
# --------------------------------------------------------------------------

_DEFAULT_IOR_TYPES = (
    DistortionType.RADIAL_DISTORTION,
    DistortionType.TANGENTIAL_DISTORTION,
    DistortionType.AFFINITY_AND_SHEAR,
)


def read_ior(path, extra_types: tuple[DistortionType, ...] = (),
             interrupt=None) -> Camera:
    """AICON `.ior` 5-line camera file (IORFileReader.java:95-206):

    line 1: camId internal ck xh yh A1 A2 R0 — ck sign-flipped;
    line 2: A3; line 3: B1 B2; line 4: C1 C2; line 5: sensor dims."""
    types = list(_DEFAULT_IOR_TYPES)
    for t in extra_types:
        if t not in types:
            types.append(t)
    camera: Optional[Camera] = None
    line_lengths = [8, 1, 2, 2, 4]
    counter = 0
    for line in _read_lines(path, "#", interrupt):
        cols = line.split()
        if counter >= len(line_lengths) or len(cols) < line_lengths[counter]:
            continue
        if counter > 0 and camera is None:
            continue
        try:
            if counter == 0:
                camid = int(cols[0])
                c = float(cols[2])
                x0, y0 = float(cols[3]), float(cols[4])
                a1, a2 = float(cols[5]), float(cols[6])
                r0 = float(cols[7])
                camera = Camera(camid, r0, types)
                camera.io.c.value = -c
                camera.io.x0.value = x0
                camera.io.y0.value = y0
                rad = camera.distortion(DistortionType.RADIAL_DISTORTION)
                rad.add(1, a1)
                rad.add(2, a2)
            elif counter == 1:
                camera.distortion(DistortionType.RADIAL_DISTORTION).add(3, float(cols[0]))
            elif counter == 2:
                tan = camera.distortion(DistortionType.TANGENTIAL_DISTORTION)
                tan.bx.value = float(cols[0])
                tan.bx.fixed = False
                tan.by.value = float(cols[1])
                tan.by.fixed = False
            elif counter == 3:
                aff = camera.distortion(DistortionType.AFFINITY_AND_SHEAR)
                aff.cx.value = float(cols[0])
                aff.cx.fixed = False
                aff.cy.value = float(cols[1])
                aff.cy.fixed = False
            counter += 1
        except ValueError:
            continue
    return camera


def read_eor(path, camera: Camera, interrupt=None) -> Camera:
    """AICON `.eor` (EORFileReader.java:70-128): keeps rows with CAP
    rotation order (col 9 == 0), active (col 10 != 0), oriented
    (col 11 != 1)."""
    for line in _read_lines(path, "#", interrupt):
        cols = line.split()
        if len(cols) < 11:
            continue
        try:
            camid = int(cols[1])
            cap = cols[8] == "0"
            enable = cols[9] != "0"
            orient = cols[10] != "1"
            if not enable or not cap or not orient or camid != camera.id:
                continue
            imgid = int(cols[0])
            vals = [float(v) for v in cols[2:8]]
        except ValueError:
            continue
        camera.add_image(imgid).eo.set(*vals)
    return camera


def read_obc(path, interrupt=None) -> dict[str, ObjectCoordinate]:
    """AICON `.obc` (OBCFileReader.java:73-111); active flag col 9."""
    out: dict[str, ObjectCoordinate] = {}
    for line in _read_lines(path, "#", interrupt):
        cols = line.split()
        if len(cols) < 4:
            continue
        enable = len(cols) < 11 or cols[8] != "0"
        if not enable:
            continue
        try:
            name = cols[0]
            x, y, z = (float(v) for v in cols[1:4])
        except ValueError:
            continue
        out[name] = ObjectCoordinate(name, x, y, z)
    return out


def read_phc(path, camera: Camera,
             coordinates: dict[str, ObjectCoordinate],
             interrupt=None) -> Camera:
    """AICON `.phc` (PHCFileReader.java:74-118); active flag col 10 > 0."""
    for line in _read_lines(path, "#", interrupt):
        cols = line.split()
        if len(cols) < 11:
            continue
        try:
            if int(cols[9]) <= 0:
                continue
            imgid = int(cols[0])
            name = cols[1]
            xp, yp, sx, sy = (float(v) for v in cols[2:6])
        except ValueError:
            continue
        image = camera.add_image(imgid)
        if name in coordinates:
            image.add(coordinates[name], xp, yp, sx, sy)
    return camera


def read_scale(path, coordinates: dict[str, ObjectCoordinate],
               interrupt=None) -> list[ScaleBar]:
    """AICON `.scale` (ScaleFileReader.java:77-110): quoted label prefix,
    then nameA nameB length sigma enable."""
    out = []
    for line in _read_lines(path, "#", interrupt):
        pos = line.rfind('"')
        line = line[pos + 1:].strip()
        cols = line.split()
        if len(cols) < 5:
            continue
        enable = cols[4] != "0"
        a, b = cols[0], cols[1]
        if not enable or a not in coordinates or b not in coordinates:
            continue
        try:
            length, sigma = float(cols[2]), float(cols[3])
        except ValueError:
            continue
        out.append(ScaleBar(coordinates[a], coordinates[b], length, sigma))
    return out


# --------------------------------------------------------------------------
# AICON HTML adjustment report (H8)
# --------------------------------------------------------------------------

_RE_SCALE = re.compile(r"^\w+\s+\w+\s+[\d.+-]+.+")
_RE_IMGCOORD = re.compile(
    r"^\w+\s+\d+\s+[\d.+-]+\s+[\d.+-]+\s+[\d.+-]+\s+[\d.+-]+\s+[\d.]+\s+"
    r"[\d.]+\s+[\d.]+\s+[\d.]+\s+[\d.]+\s+[\d.]+")
_RE_OBJCOORD = re.compile(
    r"^\w+\s+[\d.+-]+\s+[\d.+-]+\s+[\d.+-]+\s+[\d.]+\s+[\d.]+\s+[\d.]+\s+"
    r"\d+\s+\d+")
_RE_EOR_XYZ = re.compile(
    r"^\d+\s+\d+\s+[\d.+-]+\s+[\d.+-]+\s+[\d.+-]+\s+[\d.]+\s+[\d.]+\s+"
    r"[\d.]+\s+\d+")
_RE_EOR_ANGLE = re.compile(
    r"^air\s+rad\s+[\d.+-]+\s+[\d.+-]+\s+[\d.+-]+\s+[\d.]+\s+[\d.]+\s+"
    r"[\d.]+\s+[\d.]+\s+[\d.]+")
_RE_WORD = re.compile(r"\w+")

_IOR_KEYS = {
    "Ck": ("io", "c"), "Xh": ("io", "x0"), "Yh": ("io", "y0"),
    "A1": (DistortionType.RADIAL_DISTORTION, 1),
    "A2": (DistortionType.RADIAL_DISTORTION, 2),
    "A3": (DistortionType.RADIAL_DISTORTION, 3),
    "B1": (DistortionType.TANGENTIAL_DISTORTION, -1),
    "B2": (DistortionType.TANGENTIAL_DISTORTION, -2),
    "C1": (DistortionType.AFFINITY_AND_SHEAR, 0),
    "C2": (DistortionType.AFFINITY_AND_SHEAR, 1),
    "AZ1": (DistortionType.DISTANCE_DISTORTION, 1),
    "AZ2": (DistortionType.DISTANCE_DISTORTION, 2),
    "AZ3": (DistortionType.DISTANCE_DISTORTION, 3),
}


class AICONReportReader:
    """Parses a full AICON 3D Studio HTML adjustment report into cameras,
    images, object points and scale bars (AICONReportFileReader.java:52-392).

    Section anchors: HTML element names (`name="interior_orientations"`, ...)
    or the German plain-text headings."""

    def __init__(self, path,
                 datum_coordinates: Optional[dict[str, ObjectCoordinate]] = None,
                 interrupt: Optional[ReadInterrupt] = None):
        self.path = Path(path)
        self.datum_coordinates = datum_coordinates or {}
        self.interrupt = interrupt
        self.cameras: dict[int, Camera] = {}
        self.images: dict[int, Image] = {}
        self.object_coordinates: dict[str, ObjectCoordinate] = {}
        self.scale_bars: list[ScaleBar] = []
        self._camera: Optional[Camera] = None
        self._image: Optional[Image] = None

    def read(self) -> "AICONReportReader":
        section = None
        for line in _read_lines(self.path, interrupt=self.interrupt):
            line = line.strip()
            if "#Start" in line or "zum Anfang" in line:
                section = None
            if 'name="interior_orientations"' in line or "*** Innere Orientierungen ***" in line:
                section = "ior"
            if 'name="exterior_orientations"' in line or "ussere Orientierungen ***" in line:
                section = "eor"
            if 'name="object_points"' in line or "*** Objektpunkte ***" in line:
                section = "obj"
            if 'name="image_coordinates"' in line or "*** Bildkoordinaten ***" in line:
                section = "img"
            if 'name="distances"' in line or "*** Strecken ***" in line:
                section = "scale"

            try:
                if section == "ior":
                    self._parse_ior(line)
                elif section == "eor":
                    self._parse_eor(line)
                elif section == "obj":
                    self._parse_obj(line)
                elif section == "img":
                    self._parse_img(line)
                elif section == "scale":
                    self._parse_scale(line)
            except (ValueError, KeyError):
                continue
        return self

    # -- section parsers ---------------------------------------------------
    def _parse_ior(self, line: str) -> None:
        if ":" not in line:
            return
        cols = re.split(r"[:\s]+", line)
        if len(cols) != 3:
            return
        key = cols[0]
        if key.endswith("/R0"):
            camid = int(cols[1])
            r0 = float(cols[2])
            self._camera = Camera(camid, r0, (
                DistortionType.RADIAL_DISTORTION,
                DistortionType.TANGENTIAL_DISTORTION,
                DistortionType.AFFINITY_AND_SHEAR,
                DistortionType.DISTANCE_DISTORTION,
            ))
            self.cameras[camid] = self._camera
            return
        if self._camera is None or key not in _IOR_KEYS:
            return
        value = float(cols[1])
        fixed = bool(_RE_WORD.fullmatch(cols[2]))
        target = _IOR_KEYS[key]
        if target[0] == "io":
            p = getattr(self._camera.io, target[1])
            if target[1] == "c":
                p.value = -value
            else:
                p.value = value
            p.fixed = fixed
        else:
            kind, order = target
            model = self._camera.distortion(kind)
            if kind in (DistortionType.RADIAL_DISTORTION,
                        DistortionType.DISTANCE_DISTORTION):
                p = model.add(order, value)
            else:
                p = model.get(order)
                p.value = value
            p.fixed = fixed

    def _parse_eor(self, line: str) -> None:
        if _RE_EOR_XYZ.fullmatch(line):
            cols = line.split()
            camera = self.cameras.get(int(cols[1]))
            if camera is None:
                return
            imgid = int(cols[0])
            self._image = camera.add_image(imgid)
            eo = self._image.eo
            eo.x0.value, eo.y0.value, eo.z0.value = (
                float(cols[2]), float(cols[3]), float(cols[4]))
            self.images[imgid] = self._image
        elif self._image is not None and _RE_EOR_ANGLE.fullmatch(line):
            cols = line.split()
            eo = self._image.eo
            eo.omega.value, eo.phi.value, eo.kappa.value = (
                float(cols[2]), float(cols[3]), float(cols[4]))

    def _parse_obj(self, line: str) -> None:
        if not _RE_OBJCOORD.fullmatch(line):
            return
        cols = line.split()
        if len(cols) != 9:
            return
        name = cols[0]
        oc = ObjectCoordinate(name, float(cols[1]), float(cols[2]), float(cols[3]))
        oc.set_datum(not self.datum_coordinates)
        if self.datum_coordinates and name in self.datum_coordinates:
            oc = self.datum_coordinates[name]
        self.object_coordinates[name] = oc

    def _parse_img(self, line: str) -> None:
        if line.endswith("***"):  # outlier filter
            return
        if not _RE_IMGCOORD.fullmatch(line):
            return
        cols = line.split()
        if len(cols) != 12:
            return
        name = cols[0]
        imgid = int(cols[1])
        if name not in self.object_coordinates or imgid not in self.images:
            return
        xp, yp = float(cols[2]), float(cols[3])
        sx, sy = float(cols[6]), float(cols[7])
        self.images[imgid].add(self.object_coordinates[name], xp, yp, sx, sy)

    def _parse_scale(self, line: str) -> None:
        if not _RE_SCALE.fullmatch(line):
            return
        cols = line.split()
        if len(cols) < 7:
            return
        a, b = cols[0], cols[1]
        if a not in self.object_coordinates or b not in self.object_coordinates or a == b:
            return
        value = float(cols[2])
        sigma = float(cols[5])
        self.scale_bars.append(ScaleBar(
            self.object_coordinates[a], self.object_coordinates[b], value, sigma))


def read_aicon_report(path, datum_coordinates=None, device="cuda"):
    """Convenience wrapper returning a ready BundleAdjustment on ``device``
    (CUDA by default; raises without a card unless ``device="cpu"``) and
    the reader (AICONReportFileReader.readAndImport, :119-131)."""
    from ..solver.adjustment import BundleAdjustment

    adjustment = BundleAdjustment(device=device)
    reader = AICONReportReader(path, datum_coordinates).read()
    for camera in reader.cameras.values():
        adjustment.add(camera)
    for sb in reader.scale_bars:
        adjustment.add(sb)
    return adjustment, reader
