"""The port's CLI (`python -m bundle_adjustment_tpu_torch`) against the JAX
package's, on the CPU in float64.

A small network (`testing.make_synthetic_scene`, 20 points / 5 images with
distortion and a scale bar; every name at most 3 characters, so every
point is in the datum, as the CLI's name-length heuristic decides) is
written as AICON flat files and as an AICON plain-text report
(`io/scene_files.py`).  The port's `main([..., "--cpu"])` and the JAX
`main([...])` run on the same files; the numbers they print agree within
1e-9 relative (the coordinate lines print 5 decimals, so there the
tolerance is half a unit of the last digit where that is larger; the
estimation-time line is left out).  Covered: both subcommands (the flat
one with FULL inversion and the exported `.info` / `.cxx` / `.mat`, whose
covariance agrees within FULL's 1e-8 of tests/test_torch_adjustment.py,
here in the correlation scale; the report with the default REDUCED), every `--fix` name, an unknown `--fix`
name (SystemExit), `--simulation`, `--checkpoint` with LM damping and then
`--resume`.  Without a card and without `--cpu` the CLI exits non-zero
and names `--cpu`.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io as sio
import torch

from test_torch_io import _corr_err, _info
from bundle_adjustment_tpu.__main__ import main as j_main
from bundle_adjustment_tpu_torch.__main__ import _apply_fixes
from bundle_adjustment_tpu_torch.__main__ import main as t_main
from bundle_adjustment_tpu_torch.io import scene_files
from bundle_adjustment_tpu_torch.solver.checkpoint import LMCheckpoint
from bundle_adjustment_tpu_torch.testing import make_synthetic_scene
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXES = ["x0", "y0", "c", "A1", "A2", "A3", "Bx", "By", "Cx", "Cy"]


def _numbers(out):
    """(coordinate rows [name, 6 floats], summary values) of the CLI's
    stdout; the estimation-time line is left out."""
    rows, summary = [], {}
    for line in out.splitlines():
        if ":" in line:
            key, val = line.split(":", 1)
            if not key.startswith("Estimation time"):
                summary[key.strip()] = float(val)
        elif line.strip():
            parts = line.split("\t")
            rows.append((parts[0].strip(), [float(v) for v in parts[1:]]))
    return rows, summary


def _same_output(out_t, out_j):
    rt, st = _numbers(out_t)
    rj, sj = _numbers(out_j)
    assert [r[0] for r in rt] == [r[0] for r in rj] and rj
    a = np.array([r[1] for r in rt])
    b = np.array([r[1] for r in rj])
    assert (np.abs(a - b) <= np.maximum(1e-9 * np.abs(b), 0.5e-5 + 1e-12)).all()
    assert st.keys() == sj.keys() and len(sj) == 6
    for k in sj:
        if k.startswith(("Number", "Degree")):
            assert st[k] == sj[k], k
        else:
            assert st[k] == pytest.approx(sj[k], rel=1e-9, abs=1e-300), k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs on the same files, each run once per option set."""
    d = tmp_path_factory.mktemp("cli")
    cams, bars, _ = make_synthetic_scene(num_points=20, num_images=5,
                                         noise=5e-4, sigma=5e-4,
                                         perturb=0.01, seed=6)
    base = str(d / "net")
    scene_files.write_aicon_files(base, cams[0], bars)
    scene_files.write_aicon_report(base + ".txt", cams[0], bars)
    fixes = [a for f in FIXES for a in ("--fix", f)]
    argvs = {
        "flat": ["flat", base, "--quiet", "--inversion", "full"],
        "report": ["report", base + ".txt", "--quiet"],
        "fixed_checkpoint": ["flat", base, "--quiet", "--damping", "1e6",
                             *fixes],
        "simulation": ["flat", base, "--quiet", "--simulation",
                       "--inversion", "full"],
    }
    out = {}

    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, buf.getvalue()

    for side, main, extra in (("jax", j_main, []), ("port", t_main,
                                                     ["--cpu"])):
        for name, argv in argvs.items():
            argv = list(argv) + extra
            if name == "flat":
                argv += ["--export", str(d / side), "--export-mat",
                         str(d / side)]
            if name == "fixed_checkpoint":
                argv += ["--checkpoint", str(d / f"{side}.npz")]
            out[side, name] = run(main, argv)
        # resume the damped run from its last checkpoint
        out[side, "resume"] = run(main, argvs["fixed_checkpoint"] + extra + [
            "--resume", str(d / f"{side}.npz")])
    return d, base, out


@pytest.mark.parametrize("name", ["flat", "report", "fixed_checkpoint",
                                  "simulation", "resume"])
def test_output_matches_jax(runs, name):
    _, _, out = runs
    (rc_t, o_t), (rc_j, o_j) = out["port", name], out["jax", name]
    assert rc_t == rc_j == 0
    _same_output(o_t, o_j)
    if name == "simulation":
        _, s = _numbers(o_t)
        assert s["Variance of unit weight (post)"] == \
            s["Variance of unit weight (prio)"]


def test_exports_match_jax(runs):
    d, _, _ = runs
    kj, vj = _info(str(d / "jax"))
    kt, vt = _info(str(d / "port"))
    assert kt == kj and kj
    assert np.abs(vt - vj).max() <= 1e-9 * np.abs(vj).max()
    # FULL inversion: its tolerance, 1e-8 (tests/test_torch_adjustment.py)
    assert _corr_err(np.loadtxt(str(d / "port.cxx")),
                     np.loadtxt(str(d / "jax.cxx"))) <= 1e-8
    mj, mt = sio.loadmat(str(d / "jax.mat")), sio.loadmat(str(d / "port.mat"))
    assert mt["number_of_unknowns"].item() == mj["number_of_unknowns"].item()
    assert _corr_err(mt["dispersion"], mj["dispersion"]) <= 1e-8


def test_checkpoint_matches_jax(runs):
    from bundle_adjustment_tpu.solver.checkpoint import LMCheckpoint as JCk

    d, _, _ = runs
    tc = LMCheckpoint.load(str(d / "port.npz"))
    jc = JCk.load(str(d / "jax.npz"))
    assert tc.iteration == jc.iteration >= 10
    assert tc.adapted_damping == pytest.approx(jc.adapted_damping, rel=1e-9)
    assert tc.omega == pytest.approx(jc.omega, rel=1e-9)
    for f in ("points", "io", "dist", "eo"):
        a, b = getattr(tc.state, f), getattr(jc.state, f)
        assert np.abs(a - b).max() <= 1e-9 * max(1.0, np.abs(b).max()), f
    np.testing.assert_allclose(tc.centroid, jc.centroid, rtol=1e-12)


def _flags(cam):
    return [p.fixed for p in cam.io.params] + [
        p.fixed for m in cam.distortion_models.values()
        for _, p in m.coefficients]


@pytest.mark.parametrize("name", FIXES)
def test_every_fix_name(name):
    """Each --fix name holds the same one parameter as the JAX CLI's."""
    from bundle_adjustment_tpu.__main__ import _apply_fixes as j_fixes
    from bundle_adjustment_tpu.models.distortion import DistortionType as JDT
    from bundle_adjustment_tpu.testing import make_synthetic_scene as j_scene
    from bundle_adjustment_tpu_torch.models.distortion import \
        DistortionType as TDT

    flags = []
    for make, fix, DT in ((make_synthetic_scene, _apply_fixes, TDT),
                          (j_scene, j_fixes, JDT)):
        cam = make(num_points=5, num_images=2)[0][0]
        cam.distortion(DT.RADIAL_DISTORTION).add(3, 0.0)  # as .ior carries
        before = _flags(cam)
        fix(cam, [name])
        flags.append((before, _flags(cam)))
    assert flags[0] == flags[1]
    assert sum(a != b for a, b in zip(*flags[0])) == 1


def test_unknown_fix_exits(runs):
    _, base, _ = runs
    with pytest.raises(SystemExit, match="unknown --fix parameter: Zq"):
        t_main(["flat", base, "--cpu", "--quiet", "--fix", "Zq"])


def test_no_card_exits_non_zero(runs, capsys):
    _, base, _ = runs
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as exc:
        t_main(["flat", base, "--quiet"])
    assert exc.value.code != 0
    assert "--cpu" in capsys.readouterr().err
    res = subprocess.run([sys.executable, "-m", "bundle_adjustment_tpu_torch",
                          "report", base + ".txt"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "--cpu" in res.stderr
    assert res.stdout == ""


def test_f32_sets_the_dtype(runs, monkeypatch, capsys):
    """--f32 runs the adjustment in float32 (the port's own; the JAX
    CLI's --f32 would switch x64 off for the whole test process).  The
    sqrt(eps_f64) stop is out of f32's reach, so a short run ends in
    NO_CONVERGENCE with exit 1, as the reference's would."""
    from bundle_adjustment_tpu_torch.solver import adjustment

    _, base, _ = runs
    seen = []
    estimate = adjustment.BundleAdjustment.estimate_model

    def spy(self):
        seen.append(self.dtype)
        return estimate(self)

    monkeypatch.setattr(adjustment.BundleAdjustment, "estimate_model", spy)
    rc = t_main(["flat", base, "--cpu", "--quiet", "--f32",
                 "--max-iterations", "3"])
    assert seen == [torch.float32]
    assert rc == 1 and "NO_CONVERGENCE" in capsys.readouterr().err
