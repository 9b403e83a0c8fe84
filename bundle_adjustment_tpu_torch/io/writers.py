"""Result writers: `.info`/`.cxx` text export and MATLAB `.mat` export
(port of `bundle_adjustment_tpu/io/writers.py`).

Ports of the reference writer stack (`util/io/writer/`, survey rows H14-H16):

* :class:`DefaultResultWriter` — `.info` (name/axis/value/covariance-index per
  object-point component) and `.cxx` (dense sigma0_post^2-scaled covariance
  sub-matrix of the object points, row/column-gathered from Qxx)
  (DefaultResultWriter.java:47-156);
* :class:`MatlabResultWriter` — MAT5 file with identical variable names:
  `variance_of_unit_weight_prio/post`, `degree_of_freedom`,
  `number_of_observations`, `number_of_unknowns`, struct arrays
  `coordinates` (with 1-based covx/covy/covz indices),
  `interior_orientations`, `distortion_parameters` (+order), and the gathered
  **unscaled cofactor** `dispersion` matrix (MatlabResultWriter.java:52-245).

The port's cofactor matrix is a tensor on the solver's device; each export
copies it to the host once (`_host_cofactor`) and gathers the exported
rows and columns there.
"""

from __future__ import annotations

import numpy as np

_IO_NAMES = ("principal_point_x", "principal_point_y", "principal_distance")


def _dist_param_name(kind, key) -> tuple[str, int]:
    """MATLAB-facing name + order for a distortion coefficient, mirroring
    ParameterType.name().toLowerCase() of the reference."""
    from ..models.distortion import DistortionType

    if kind == DistortionType.AFFINITY_AND_SHEAR:
        return ("affinity_and_shear_cx" if key == 0 else "affinity_and_shear_cy", -1)
    if kind == DistortionType.TANGENTIAL_DISTORTION:
        if key == -1:
            return ("tangential_distortion_bx", -1)
        if key == -2:
            return ("tangential_distortion_by", -1)
        return ("tangential_polynomial_b", key)
    if kind == DistortionType.RADIAL_DISTORTION:
        return ("radial_polynomial_a", key)
    if kind == DistortionType.DISTANCE_DISTORTION:
        return ("distance_polynomial_d", key)
    if kind == DistortionType.ZERNIKE_X:
        return ("zernike_polynomial_x", key)
    if kind == DistortionType.ZERNIKE_Y:
        return ("zernike_polynomial_y", key)
    return ("zernike_polynomial_z", key)


def _host_cofactor(adjustment):
    """The cofactor matrix as one host float64 array, or None where the
    adjustment has none large enough to export
    (number of unknowns + datum conditions)."""
    Q = adjustment.get_cofactor_matrix()
    total = (adjustment.get_number_of_unknown_parameters()
             + adjustment.get_number_of_datum_conditions())
    if Q is None or Q.shape[0] < total:
        return None
    if hasattr(Q, "detach"):
        Q = Q.detach().cpu().numpy()
    return np.asarray(Q, np.float64)


class BundleAdjustmentResultWriter:
    """Base: holds the export path/file base name
    (BundleAdjustmentResultWriter.java:23-42)."""

    def __init__(self, export_path_and_file_base_name: str):
        self.base = str(export_path_and_file_base_name)

    def __str__(self):
        return f"{type(self).__name__}({self.base})"

    def export(self, adjustment) -> None:
        raise NotImplementedError


class DefaultResultWriter(BundleAdjustmentResultWriter):
    def export(self, adjustment) -> None:
        indices = self._export_info(adjustment, self.base + ".info")
        self._export_cxx(adjustment, indices, self.base + ".cxx",
                         _host_cofactor(adjustment))

    def _export_info(self, adjustment, path) -> list[int]:
        indices: list[int] = []
        lines = []
        column_index = 0
        fmt = "%25s\t%5s\t%35.15f\t%10d"
        for oc in adjustment.get_object_coordinates():
            cols = []
            for p in oc.params:
                if p.column >= 0:
                    indices.append(p.column)
                    cols.append(column_index)
                    column_index += 1
                else:
                    cols.append(-1)
            for axis, p, ci in zip("XYZ", oc.params, cols):
                lines.append(fmt % (oc.name, axis, p.value, ci))
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        return indices

    def _export_cxx(self, adjustment, indices, path, Q) -> None:
        if Q is None:
            return
        s2 = adjustment.get_variance_factor_aposteriori()
        idx = np.asarray(indices, int)
        sub = s2 * Q[np.ix_(idx, idx)]
        with open(path, "w") as fh:
            for row in sub:
                fh.write("".join("%+35.15f  " % v for v in row) + "\n")


class MatlabResultWriter(BundleAdjustmentResultWriter):
    def export(self, adjustment) -> None:
        import scipy.io as sio

        Q = _host_cofactor(adjustment)
        export_disp = Q is not None

        indices: list[int] = []
        column_index = 1  # MATLAB 1-based

        coords = adjustment.get_object_coordinates()
        coord_rec = np.zeros(
            (1, len(coords)),
            dtype=[("name", "O"), ("X", "O"), ("Y", "O"), ("Z", "O"),
                   ("covx", "O"), ("covy", "O"), ("covz", "O")])
        for i, oc in enumerate(coords):
            cov = []
            for p in oc.params:
                if p.column >= 0:
                    if export_disp:
                        indices.append(p.column)
                    cov.append(column_index)
                    column_index += 1
                else:
                    cov.append(-1)
            coord_rec[0, i] = (oc.name, oc.x.value, oc.y.value, oc.z.value,
                               np.int32(cov[0]), np.int32(cov[1]), np.int32(cov[2]))

        io_rows = []
        for cam in adjustment.cameras:
            for name, p in zip(_IO_NAMES, cam.io.params):
                io_rows.append((cam.id, name, p))
        io_rec = np.zeros((1, len(io_rows)),
                          dtype=[("cam_id", "O"), ("name", "O"), ("value", "O"),
                                 ("cov", "O")])
        for i, (cid, name, p) in enumerate(io_rows):
            cov = -1
            if export_disp and p.column >= 0:
                indices.append(p.column)
                cov = column_index
                column_index += 1
            io_rec[0, i] = (np.int64(cid), name, p.value, np.int32(cov))

        dist_rows = []
        for cam in adjustment.cameras:
            for kind in sorted(cam.distortion_models.keys()):
                for key, p in cam.distortion_models[kind].coefficients:
                    name, order = _dist_param_name(kind, key)
                    dist_rows.append((cam.id, name, order, p))
        dist_rec = np.zeros((1, len(dist_rows)),
                            dtype=[("cam_id", "O"), ("name", "O"), ("value", "O"),
                                   ("order", "O"), ("cov", "O")])
        for i, (cid, name, order, p) in enumerate(dist_rows):
            cov = -1
            if export_disp and p.column >= 0:
                indices.append(p.column)
                cov = column_index
                column_index += 1
            dist_rec[0, i] = (np.int64(cid), name, p.value,
                              np.int32(order), np.int32(cov))

        mat = {
            "variance_of_unit_weight_prio": adjustment.get_variance_factor_apriori(),
            "variance_of_unit_weight_post": adjustment.get_variance_factor_aposteriori(),
            "degree_of_freedom": np.int32(adjustment.get_degree_of_freedom()),
            "number_of_observations": np.int32(adjustment.get_number_of_observations()),
            "number_of_unknowns": np.int32(adjustment.get_number_of_unknown_parameters()),
            "coordinates": coord_rec,
            "interior_orientations": io_rec,
            "distortion_parameters": dist_rec,
        }
        if export_disp:
            idx = np.asarray(indices, int)
            mat["dispersion"] = Q[np.ix_(idx, idx)]

        sio.savemat(self.base + ".mat", mat)
