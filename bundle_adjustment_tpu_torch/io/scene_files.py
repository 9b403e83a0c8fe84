"""Write a network into the input formats of `io/readers.py` and
`io/columnar.py`: the AICON 3D Studio files (.obc, .scale, .ior, .eor,
.phc), an AICON plain-text adjustment report with the German section
headings, and the generic flat files.

The readers are the contract: every file written here reads back into the
same network (the tests and `chip_smoke.py` write synthetic networks with
these and feed them to the readers, the CLI and `build_rcs_problem`).
Floats are written in their shortest round-trip form (positional, without
an exponent, where the report's patterns need that), so a value reads back
bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..models.distortion import DistortionType

#: the distortion coefficients an AICON .ior file holds, by model
IOR_COEFFICIENTS = {
    DistortionType.RADIAL_DISTORTION: {1, 2, 3},
    DistortionType.TANGENTIAL_DISTORTION: {-1, -2},
    DistortionType.AFFINITY_AND_SHEAR: {0, 1},
}


def _r(v) -> str:
    """Shortest round-trip decimal of a float (may use an exponent)."""
    return repr(float(v))


def _p(v) -> str:
    """Shortest round-trip decimal of a float, positional (no exponent)."""
    return np.format_float_positional(float(v), unique=True, trim="0")


def _coefficients(camera) -> dict:
    """{(kind, key): Parameter} of the camera's distortion coefficients;
    raises ValueError for one an .ior file cannot hold."""
    out = {}
    for kind, model in camera.distortion_models.items():
        for key, p in model.coefficients:
            if key not in IOR_COEFFICIENTS.get(DistortionType(int(kind)), ()):
                raise ValueError(
                    f"distortion coefficient {DistortionType(int(kind)).name}"
                    f"[{key}] does not fit an AICON .ior file (radial A1-A3, "
                    "tangential B1/B2, affinity C1/C2)")
            out[(DistortionType(int(kind)), key)] = p
    return out


def _coefficient(coeffs, kind, key) -> float:
    p = coeffs.get((kind, key))
    return 0.0 if p is None else p.value


def _object_coordinates(camera) -> list:
    """The object points the camera's images see, in first-seen order."""
    seen = {}
    for image in camera:
        for ic in image:
            seen.setdefault(id(ic.object_coordinate), ic.object_coordinate)
    return list(seen.values())


def write_aicon_files(base: str, camera, scale_bars=()) -> None:
    """``base``.obc / .scale / .ior / .eor / .phc of one camera, its images
    and image points (the formats of `readers.read_obc`, `read_scale`,
    `read_ior`, `read_eor`, `read_phc`).  Every record is active; the
    distortion stack must fit .ior (radial A1-A3, B1/B2, C1/C2; absent
    coefficients are written as 0 and read back as free)."""
    coeffs = _coefficients(camera)
    io = camera.interior_orientation
    rad = DistortionType.RADIAL_DISTORTION
    tan = DistortionType.TANGENTIAL_DISTORTION
    aff = DistortionType.AFFINITY_AND_SHEAR
    with open(base + ".ior", "w") as fh:
        fh.write(f"{camera.id} 0 {_r(-io.c.value)} {_r(io.x0.value)} "
                 f"{_r(io.y0.value)} {_r(_coefficient(coeffs, rad, 1))} "
                 f"{_r(_coefficient(coeffs, rad, 2))} {_r(camera.r0)}\n")
        fh.write(f"{_r(_coefficient(coeffs, rad, 3))}\n")
        fh.write(f"{_r(_coefficient(coeffs, tan, -1))} "
                 f"{_r(_coefficient(coeffs, tan, -2))}\n")
        fh.write(f"{_r(_coefficient(coeffs, aff, 0))} "
                 f"{_r(_coefficient(coeffs, aff, 1))}\n")
        fh.write("0 0 0 0\n")
    with open(base + ".eor", "w") as fh:
        for image in camera:
            vals = " ".join(_r(p.value) for p in image.exterior_orientation
                            .params)
            # rotation order CAP (0), active (1), not excluded (0)
            fh.write(f"{image.id} {camera.id} {vals} 0 1 0\n")
    with open(base + ".obc", "w") as fh:
        for oc in _object_coordinates(camera):
            fh.write(f"{oc.name} {_r(oc.x.value)} {_r(oc.y.value)} "
                     f"{_r(oc.z.value)}\n")
    with open(base + ".phc", "w") as fh:
        for image in camera:
            for ic in image:
                fh.write(f"{image.id} {ic.object_coordinate.name} {_r(ic.x)} "
                         f"{_r(ic.y)} {_r(np.sqrt(ic.var_x))} "
                         f"{_r(np.sqrt(ic.var_y))} 0 0 0 1 0\n")
    with open(base + ".scale", "w") as fh:
        for i, sb in enumerate(scale_bars):
            fh.write(f'"bar {i}" {sb.coordinate_a.name} '
                     f"{sb.coordinate_b.name} {_r(sb.length)} "
                     f"{_r(np.sqrt(sb.variance))} 1\n")


_IOR_REPORT_KEYS = (
    ("A1", DistortionType.RADIAL_DISTORTION, 1),
    ("A2", DistortionType.RADIAL_DISTORTION, 2),
    ("A3", DistortionType.RADIAL_DISTORTION, 3),
    ("B1", DistortionType.TANGENTIAL_DISTORTION, -1),
    ("B2", DistortionType.TANGENTIAL_DISTORTION, -2),
    ("C1", DistortionType.AFFINITY_AND_SHEAR, 0),
    ("C2", DistortionType.AFFINITY_AND_SHEAR, 1),
)


def write_aicon_report(path: str, camera, scale_bars=()) -> None:
    """An AICON plain-text adjustment report of one camera (the sections
    and line patterns `readers.AICONReportReader.read` accepts, under the
    German headings): interior orientation with each parameter's fixed
    flag, exterior orientations, object points, image coordinates and
    scale bars.  Only the coefficients the camera has are written."""
    coeffs = _coefficients(camera)
    io = camera.interior_orientation

    def flag(p) -> str:
        return "fixed" if p.fixed else "0.001"

    lines = ["AICON 3D Studio", "", "*** Innere Orientierungen ***",
             f"Kamera/R0: {camera.id} {_r(camera.r0)}",
             f"Ck: {_r(-io.c.value)} {flag(io.c)}",
             f"Xh: {_r(io.x0.value)} {flag(io.x0)}",
             f"Yh: {_r(io.y0.value)} {flag(io.y0)}"]
    for name, kind, key in _IOR_REPORT_KEYS:
        p = coeffs.get((kind, key))
        if p is not None:
            lines.append(f"{name}: {_r(p.value)} {flag(p)}")
    lines += ["", "*** Äussere Orientierungen ***"]
    for image in camera:
        eo = image.exterior_orientation
        lines.append(f"{image.id} {camera.id} {_p(eo.x0.value)} "
                     f"{_p(eo.y0.value)} {_p(eo.z0.value)} 0.01 0.01 0.01 1")
        lines.append(f"air rad {_p(eo.omega.value)} {_p(eo.phi.value)} "
                     f"{_p(eo.kappa.value)} 0.0001 0.0001 0.0001 0 0")
    lines += ["", "*** Objektpunkte ***"]
    for oc in _object_coordinates(camera):
        lines.append(f"{oc.name} {_p(oc.x.value)} {_p(oc.y.value)} "
                     f"{_p(oc.z.value)} 0.01 0.01 0.01 2 0")
    lines += ["", "*** Bildkoordinaten ***"]
    for image in camera:
        for ic in image:
            lines.append(f"{ic.object_coordinate.name} {image.id} {_p(ic.x)} "
                         f"{_p(ic.y)} 0 0 {_p(np.sqrt(ic.var_x))} "
                         f"{_p(np.sqrt(ic.var_y))} 0 0 0 0")
    lines += ["", "*** Strecken ***"]
    for sb in scale_bars:
        lines.append(f"{sb.coordinate_a.name} {sb.coordinate_b.name} "
                     f"{_p(sb.length)} 0 0 {_p(np.sqrt(sb.variance))} 0")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")


def write_flat_files(base: str, names, xyz, datum, obs_point, obs_image,
                     obs_xy, sigma, eo, io, camera_id=1,
                     image_ids=None) -> dict:
    """The generic flat files of a one-camera network (the formats of
    `columnar.load_*` and `readers.read_*_flat`), with 17 significant
    digits: ``base``.points (`name X Y Z [1]`, the datum column on the
    points with ``datum``), .imagecoords (`camId imgId name x y sx sy 0`,
    one row per observation in the given order), .eor and .ior.  Image m
    gets id ``image_ids[m]`` (default m + 1).  Returns the four paths."""
    names = list(names)
    xyz = np.asarray(xyz, np.float64)
    datum = np.asarray(datum, bool)
    eo = np.asarray(eo, np.float64)
    M = eo.shape[0]
    ids = np.arange(1, M + 1) if image_ids is None else np.asarray(image_ids)
    sig = np.broadcast_to(np.asarray(sigma, np.float64),
                          np.asarray(obs_xy).shape)
    paths = {k: f"{base}.{k}" for k in ("points", "imagecoords", "eor",
                                         "ior")}
    with open(paths["points"], "w") as fh:
        fh.write("".join(
            "%s %.17g %.17g %.17g%s\n" % (n, *p, " 1" if d else "")
            for n, p, d in zip(names, xyz.tolist(), datum.tolist())))
    with open(paths["imagecoords"], "w") as fh:
        fh.write("".join(
            "%d %d %s %.17g %.17g %.17g %.17g 0\n"
            % (camera_id, ids[m], names[p], x, y, sx, sy)
            for p, m, (x, y), (sx, sy) in zip(
                np.asarray(obs_point).tolist(), np.asarray(obs_image).tolist(),
                np.asarray(obs_xy, np.float64).tolist(), sig.tolist())))
    with open(paths["eor"], "w") as fh:
        fh.write("".join("%d %d %.17g %.17g %.17g %.17g %.17g %.17g\n"
                         % (camera_id, i, *row)
                         for i, row in zip(ids.tolist(), eo.tolist())))
    with open(paths["ior"], "w") as fh:
        fh.write("%d %.17g %.17g %.17g\n"
                 % (camera_id, *np.asarray(io, np.float64).reshape(3)))
    return paths
