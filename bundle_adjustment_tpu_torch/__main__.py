"""Command-line interface (port of `bundle_adjustment_tpu/__main__.py`).

The reference has no CLI (its example mains are the entry points, survey L6);
this is the equivalent turned into a proper tool:

    python -m bundle_adjustment_tpu_torch report  path/to/report.htm  [options]
    python -m bundle_adjustment_tpu_torch flat    path/to/basename    [options]

Both read a network, run the adjustment and print the coordinate/IO/
distortion results and global statistics; writers are optional.  The
adjustment runs in float64 on the CUDA card (``--f32``: float32); without
a card it exits non-zero unless ``--cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time


def _common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--inversion", default="reduced",
                        choices=["none", "full", "reduced", "pre_elimination"],
                        help="covariance mode (MatrixInversion)")
    parser.add_argument("--simulation", action="store_true",
                        help="SIMULATION mode: pure covariance propagation")
    parser.add_argument("--damping", type=float, default=0.0,
                        help="initial Levenberg-Marquardt damping value")
    parser.add_argument("--max-iterations", type=int, default=5000)
    parser.add_argument("--no-centroid", action="store_true",
                        help="disable centroid centering")
    parser.add_argument("--export", metavar="BASE",
                        help="write BASE.info/.cxx result files")
    parser.add_argument("--export-mat", metavar="BASE",
                        help="write BASE.mat (MATLAB) result file")
    parser.add_argument("--checkpoint", metavar="PATH",
                        help="write LM checkpoints to PATH")
    parser.add_argument("--resume", metavar="PATH",
                        help="resume from an LM checkpoint")
    parser.add_argument("--datum-name-length", type=int, default=3,
                        help="points with names longer than this are not "
                             "datum points (reference example heuristic)")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA card)")
    parser.add_argument("--f32", action="store_true",
                        help="single precision (default: float64)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bundle_adjustment_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_rep = sub.add_parser("report", help="adjust from an AICON HTML report")
    p_rep.add_argument("path")
    _common(p_rep)

    p_flat = sub.add_parser("flat", help="adjust from AICON flat files "
                                         "(basename.{obc,scale,ior,eor,phc})")
    p_flat.add_argument("basename")
    p_flat.add_argument("--fix", action="append", default=[],
                        metavar="PARAM",
                        help="hold a camera parameter fixed (x0, y0, c, "
                             "A1..A3, Bx, By, Cx, Cy); repeatable")
    _common(p_flat)

    args = parser.parse_args(argv)
    import numpy as np
    import torch

    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device (torch.cuda.is_available() is false); "
                     "pass --cpu to run on the CPU")
    device = "cpu" if args.cpu else "cuda"

    from .solver.adjustment import (
        EstimationState,
        EstimationType,
        MatrixInversion,
    )

    t0 = time.time()
    if args.command == "report":
        from .io.readers import read_aicon_report

        adjustment, reader = read_aicon_report(args.path, device=device)
        cameras = list(reader.cameras.values())
    else:
        from .io.readers import read_eor, read_ior, read_obc, read_phc, read_scale
        from .solver.adjustment import BundleAdjustment

        base = args.basename
        coords = read_obc(base + ".obc")
        bars = read_scale(base + ".scale", coords)
        camera = read_ior(base + ".ior")
        _apply_fixes(camera, args.fix)
        read_eor(base + ".eor", camera)
        read_phc(base + ".phc", camera, coords)
        adjustment = BundleAdjustment(device=device)
        adjustment.add(camera)
        for sb in bars:
            adjustment.add(sb)
        cameras = [camera]

    # datum heuristic of the reference examples
    for camera in cameras:
        for image in camera:
            for ic in image:
                if len(ic.object_coordinate.name) > args.datum_name_length:
                    ic.object_coordinate.set_datum(False)

    if args.f32:
        adjustment.dtype = torch.float32
    adjustment.set_invert_normal_equation(MatrixInversion(args.inversion))
    adjustment.set_maximal_number_of_iterations(args.max_iterations)
    if args.simulation:
        adjustment.set_estimation_type(EstimationType.SIMULATION)
    if args.damping:
        adjustment.set_levenberg_marquardt_damping_value(args.damping)
    if args.no_centroid:
        adjustment.use_centroided_coordinates = False
    if args.checkpoint:
        adjustment.set_checkpointing(args.checkpoint)
    if args.resume:
        adjustment.resume_from(args.resume)
    if not args.quiet:
        adjustment.add_property_change_listener(
            lambda n, o, v: print(f"Info: {n} {o} --> {v}", file=sys.stderr))

    status = adjustment.estimate_model()
    if status != EstimationState.ERROR_FREE_ESTIMATION:
        print(f"Error, bundle adjustment failed: {status.name}",
              file=sys.stderr)
        return 1

    if args.export:
        from .io.writers import DefaultResultWriter

        DefaultResultWriter(args.export).export(adjustment)
    if args.export_mat:
        from .io.writers import MatlabResultWriter

        MatlabResultWriter(args.export_mat).export(adjustment)

    D = adjustment.get_cofactor_matrix()
    if D is not None:  # one copy to the host, not one per coordinate
        D = D.detach().cpu().numpy()
    s2 = adjustment.get_variance_factor_aposteriori()
    for oc in adjustment.get_object_coordinates():
        u = [0.0, 0.0, 0.0]
        if D is not None and all(p.column >= 0 for p in oc.params):
            u = [float(np.sqrt(abs(s2 * D[p.column, p.column])))
                 for p in oc.params]
        print(f"{oc.name:>10}\t{oc.x.value:+16.5f}\t{oc.y.value:+16.5f}\t"
              f"{oc.z.value:+16.5f}\t{u[0]:+12.5f}\t{u[1]:+12.5f}\t"
              f"{u[2]:+12.5f}")
    print()
    print("Number of observations:          ",
          adjustment.get_number_of_observations())
    print("Number of unknown parameters:    ",
          adjustment.get_number_of_unknown_parameters())
    print("Number of datum conditions:      ",
          adjustment.get_number_of_datum_conditions())
    print("Degree of freedom:               ",
          adjustment.get_degree_of_freedom())
    print("Variance of unit weight (prio):  ",
          adjustment.get_variance_factor_apriori())
    print("Variance of unit weight (post):  ", s2)
    print(f"Estimation time:                  {time.time() - t0:.3f} sec")
    return 0


def _apply_fixes(camera, fixes) -> None:
    from .models.distortion import DistortionType

    for name in fixes:
        key = name.strip()
        if key in ("x0", "y0", "c"):
            getattr(camera.io, key).fixed = True
        elif key.startswith("A"):
            camera.distortion(DistortionType.RADIAL_DISTORTION).get(
                int(key[1:])).fixed = True
        elif key in ("Bx", "By"):
            m = camera.distortion(DistortionType.TANGENTIAL_DISTORTION)
            (m.bx if key == "Bx" else m.by).fixed = True
        elif key in ("Cx", "Cy"):
            m = camera.distortion(DistortionType.AFFINITY_AND_SHEAR)
            (m.cx if key == "Cx" else m.cy).fixed = True
        else:
            raise SystemExit(f"unknown --fix parameter: {name}")


if __name__ == "__main__":
    sys.exit(main())
