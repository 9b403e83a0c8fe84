"""The port's file I/O against the JAX package's, on the CPU.

* `native`: the C++ table loader builds with g++ into `.kernels_build/`
  (no shared library next to the package's sources) and raises when the
  compiler is missing; the parse cases of tests/test_native_loader.py on
  the port's `parse_table` and `parse_table_py`, equal to JAX's; the C++
  source is the JAX package's, unchanged.
* `io/readers.py`: the generic flat, AICON flat and AICON report readers
  on the same files (a synthetic network written by `io/scene_files.py`,
  plus comment, malformed, inactive and foreign rows) give the same
  network as the JAX readers: every value, fixed flag, datum flag, image
  point and bar equal.  `ReadInterrupt` and the shared lock as in
  tests/test_aux.py.
* `io/writers.py`: `.info`, `.cxx` and `.mat` of the port's dense REDUCED
  estimate against the JAX package's on the same scene (coordinates within
  1e-9 of the field, the covariance in its correlation scale within 1e-7:
  the REDUCED tolerance of tests/test_torch_adjustment.py), and the
  `ScaleBundleAdjustment` writer export against the JAX dense `.info`
  (1e-8, as tests/test_scale_driver.py's `test_writer_export`).
"""

import os

import numpy as np
import pytest
import scipy.io as sio
import torch

from bundle_adjustment_tpu import BundleAdjustment as JBA
from bundle_adjustment_tpu import MatrixInversion as JMI
from bundle_adjustment_tpu import native as jnative
from bundle_adjustment_tpu.io import readers as JR
from bundle_adjustment_tpu.io import writers as JW
from bundle_adjustment_tpu.testing import make_synthetic_scene as j_scene
from bundle_adjustment_tpu_torch import BundleAdjustment, MatrixInversion
from bundle_adjustment_tpu_torch import native
from bundle_adjustment_tpu_torch.io import readers as TR
from bundle_adjustment_tpu_torch.io import scene_files
from bundle_adjustment_tpu_torch.io import writers as TW
from bundle_adjustment_tpu_torch.testing import make_synthetic_scene
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


# ---- native loader ---------------------------------------------------------

def test_loader_builds_into_the_build_directory():
    lib = native.build()
    assert lib.is_file() and lib.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT.name == ".kernels_build"
    pkg = native.SRC.parent.parent
    assert not list(pkg.rglob("*.so"))
    assert native.SRC.read_bytes() == (
        native.SRC.parents[2] / "bundle_adjustment_tpu" / "native"
        / "loader.cpp").read_bytes()


def test_loader_raises_without_compiler(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.LoaderBuildError, match="g\\+\\+"):
        native.parse_table(tmp_path / "t.txt", "f")
    assert native._lib is None and not any(tmp_path.rglob("*.so"))


def test_native_available_follows_the_build(monkeypatch, tmp_path):
    """`native_available` (the JAX package's function) is True where the
    g++ build succeeds and False where it fails, without raising."""
    try:
        native.build()
        builds = True
    except native.LoaderBuildError:
        builds = False
    assert native.native_available() == builds
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    assert native.native_available() is False


def _semantics_file(tmp_path):
    p = tmp_path / "t.txt"
    p.write_text(
        "﻿P1 1.5 -2.5e3 0.25 1\r\n"
        "# comment line\n"
        "   \n"
        "P2 bad 2.0 3.0\n"          # unparsable float -> row dropped
        "P3 4.0 5.0 6.0\n"           # no datum column
        "P1 7.0 8.0 9.0 0\n",        # repeated key -> same id
        encoding="utf-8")
    return p


def _int_file(tmp_path):
    p = tmp_path / "i.txt"
    p.write_text("1 10.0\n2.5 20.0\n3 30.0\n")
    return p


def _same_table(a, b):
    assert a.rows == b.rows
    np.testing.assert_array_equal(a.floats, b.floats)
    np.testing.assert_array_equal(a.ncols, b.ncols)
    assert len(a.keys) == len(b.keys)
    for (ia, ua), (ib, ub) in zip(a.keys, b.keys):
        np.testing.assert_array_equal(ia, ib)
        assert ua == ub


@pytest.mark.parametrize("fn", ["parse_table", "parse_table_py"])
def test_parse_semantics(fn, tmp_path):
    """BOM strip, comment skip, CRLF, optional columns, skip-on-parse-error,
    string interning (tests/test_native_loader.py), and the same table as
    the JAX loader's."""
    p = _semantics_file(tmp_path)
    t = getattr(native, fn)(str(p), "sfffs")
    assert t.rows == 3
    ids, names = t.keys[0]
    assert names[ids[0]] == "P1" and names[ids[2]] == "P1"
    assert ids[0] == ids[2]
    assert names[ids[1]] == "P3"
    np.testing.assert_allclose(t.floats[0], [1.5, -2.5e3, 0.25])
    dat_ids, dat_uniq = t.keys[1]
    assert dat_ids[1] == -1
    assert dat_uniq[dat_ids[0]] == "1"
    np.testing.assert_array_equal(t.ncols, [5, 4, 5])
    _same_table(t, jnative.parse_table_py(str(p), "sfffs"))


@pytest.mark.parametrize("fn", ["parse_table", "parse_table_py"])
def test_int_column_rejects_floats(fn, tmp_path):
    p = _int_file(tmp_path)
    t = getattr(native, fn)(str(p), "if")
    assert t.rows == 2
    np.testing.assert_allclose(t.floats[:, 0], [1.0, 3.0])
    _same_table(t, jnative.parse_table_py(str(p), "if"))


def test_native_matches_python_on_a_network(tmp_path):
    cams, _, _ = make_synthetic_scene(num_points=30, num_images=6, seed=4)
    scene_files.write_aicon_files(str(tmp_path / "net"), cams[0])
    path = str(tmp_path / "net.phc")
    _same_table(native.parse_table(path, "isfffffffff"),
                native.parse_table_py(path, "isfffffffff"))
    _same_table(native.parse_table(path, "isfffffffff"),
                jnative.parse_table_py(path, "isfffffffff"))


# ---- readers ---------------------------------------------------------------

def _param(p):
    return (p.value, p.fixed)


def _cameras(cameras):
    out = []
    for cam in cameras:
        dist = {int(k): [(key, _param(p)) for key, p in m.coefficients]
                for k, m in cam.distortion_models.items()}
        images = []
        for img in cam:
            pts = [(ic.object_coordinate.name, ic.x, ic.y, ic.var_x, ic.var_y,
                    ic.rho) for ic in img]
            images.append((img.id, [_param(p) for p in img.eo.params], pts))
        out.append((cam.id, cam.r0, [_param(p) for p in cam.io.params],
                    dist, images))
    return out


def _coords(coords):
    return {n: (oc.x.value, oc.y.value, oc.z.value, oc.datum,
                [p.fixed for p in oc.params]) for n, oc in coords.items()}


def _bars(bars):
    return [(sb.coordinate_a.name, sb.coordinate_b.name, sb.length,
             sb.variance) for sb in bars]


@pytest.fixture(scope="module")
def network(tmp_path_factory):
    """A small network written in every input format, with extra rows the
    readers must skip or keep: comments, malformed numbers, inactive and
    foreign records, repeated names, a datum column, rho."""
    d = tmp_path_factory.mktemp("net")
    cams, bars, _ = make_synthetic_scene(num_points=20, num_images=5,
                                         noise=1e-4, seed=8)
    base = str(d / "net")
    scene_files.write_aicon_files(base, cams[0], bars)
    scene_files.write_aicon_report(base + ".txt", cams[0], bars)
    with open(base + ".obc", "a") as fh:
        fh.write("# comment\nBAD 1.0 x 2.0\nOFF 1 2 3 0 0 0 0 0 0 0\n")
    with open(base + ".eor", "a") as fh:
        fh.write("77 1 1 2 3 0 0 0 0 0 0\n"     # inactive
                 "78 1 1 2 3 0 0 0 1 1 0\n"     # not CAP
                 "79 2 1 2 3 0 0 0 0 1 0\n")    # other camera
    with open(base + ".phc", "a") as fh:
        fh.write("1 1 0.5 0.5 0.001 0.001 0 0 0 0 0\n"   # inactive
                 "1 NOPE 0.5 0.5 0.001 0.001 0 0 0 1 0\n")
    with open(base + ".scale", "a") as fh:
        fh.write('"off" 1 2 10.0 0.01 0\n"x" 1 NOPE 10.0 0.01 1\n')
    with open(base + ".txt", "a", encoding="utf-8") as fh:
        fh.write("*** Bildkoordinaten ***\n"
                 "1 1 0.5 0.5 0 0 0.001 0.001 0 0 0 0 ***\n")
    seen = {ic.object_coordinate.name: ic.object_coordinate
            for img in cams[0] for ic in img}
    names = list(seen)
    pts = np.array([[oc.x.value, oc.y.value, oc.z.value]
                    for oc in seen.values()])
    obs = [(names.index(ic.object_coordinate.name), m, ic.x, ic.y)
           for m, img in enumerate(cams[0]) for ic in img]
    eo = np.array([[p.value for p in img.eo.params] for img in cams[0]])
    flat = scene_files.write_flat_files(
        str(d / "flat"), names, pts, np.arange(len(names)) < 3,
        [o[0] for o in obs], [o[1] for o in obs], [o[2:] for o in obs],
        1e-3, eo, [p.value for p in cams[0].io.params])
    with open(flat["points"], "a") as fh:
        fh.write("# c\nQ 1 2 x\nQ 1 2 3 0\nQ 4 5 6 1\n")
    with open(flat["imagecoords"], "a") as fh:
        fh.write("1 1 1 0.1 0.2 0.001 0.002 0.3\n"   # rho column
                 "2 1 1 0.1 0.2 0.001 0.001\n"       # other camera
                 "1 1 NOPE 0.1 0.2 0.001 0.001\n")
    with open(flat["eor"], "a") as fh:
        fh.write("1 99 1 2 3 0 0 x\n")
    with open(flat["ior"], "a") as fh:
        fh.write("2 0.1 0.2 -31\n")
    return base, flat


def _flat(R, Camera, flat):
    coords = R.read_object_coordinates_flat(flat["points"])
    cam = Camera(1)
    R.read_interior_orientation_flat(flat["ior"], cam)
    R.read_exterior_orientations_flat(flat["eor"], cam)
    R.read_image_coordinates_flat(flat["imagecoords"], cam, coords)
    bars_path = flat["points"] + ".bars"
    with open(bars_path, "w") as fh:
        fh.write("1 2 10.5 0.01\n1 NOPE 3 0.1\n# x\n2 3 bad 0.1\n")
    return [cam], coords, R.read_scale_bars_flat(bars_path, coords)


def _aicon(R, base):
    coords = R.read_obc(base + ".obc")
    bars = R.read_scale(base + ".scale", coords)
    cam = R.read_ior(base + ".ior")
    R.read_eor(base + ".eor", cam)
    R.read_phc(base + ".phc", cam, coords)
    return [cam], coords, bars


def _report(R, base):
    r = R.AICONReportReader(base + ".txt").read()
    return list(r.cameras.values()), r.object_coordinates, r.scale_bars


@pytest.mark.parametrize("fmt", ["flat", "aicon", "report"])
def test_readers_match_jax(fmt, network):
    from bundle_adjustment_tpu.models.scene import Camera as JCamera
    from bundle_adjustment_tpu_torch.models.scene import Camera as TCamera

    base, flat = network
    if fmt == "flat":
        j, t = _flat(JR, JCamera, flat), _flat(TR, TCamera, flat)
    elif fmt == "aicon":
        j, t = _aicon(JR, base), _aicon(TR, base)
    else:
        j, t = _report(JR, base), _report(TR, base)
    assert _cameras(t[0]) == _cameras(j[0])
    assert _coords(t[1]) == _coords(j[1])
    assert _bars(t[2]) == _bars(j[2])
    # the fixtures exercise what they claim
    assert len(t[1]) >= 20 and sum(len(img) for img in t[0][0]) > 50
    if fmt != "report":
        assert len(t[2]) == 1


def test_files_read_back_the_network(network, tmp_path):
    """`scene_files` writes what the readers read: the AICON files and the
    report give the scene's images, points and values back."""
    cams, bars, _ = make_synthetic_scene(num_points=20, num_images=5,
                                         noise=1e-4, seed=8)
    base = str(tmp_path / "again")
    scene_files.write_aicon_files(base, cams[0], bars)
    got = _aicon(TR, base)
    ref = _cameras(cams)[0]
    back = _cameras(got[0])[0]
    assert [i[0] for i in back[4]] == [i[0] for i in ref[4]]
    for (_, eo_b, pts_b), (_, eo_r, pts_r) in zip(back[4], ref[4]):
        assert [v for v, _ in eo_b] == [v for v, _ in eo_r]
        assert [p[:3] for p in pts_b] == [p[:3] for p in pts_r]
        np.testing.assert_allclose([p[3:5] for p in pts_b],
                                   [p[3:5] for p in pts_r], rtol=1e-15)
    assert back[2] == ref[2]
    assert _bars(got[2])[0][:3] == _bars(bars)[0][:3]


def test_ior_refuses_a_stack_it_cannot_hold(tmp_path):
    from bundle_adjustment_tpu_torch.models.distortion import DistortionType

    cams, _, _ = make_synthetic_scene(num_points=10, num_images=3, seed=1)
    cams[0].distortion(DistortionType.RADIAL_DISTORTION).add(4, 1e-9)
    with pytest.raises(ValueError, match="does not fit"):
        scene_files.write_aicon_files(str(tmp_path / "x"), cams[0])


def test_reader_interrupt_and_lock(tmp_path):
    """Cooperative interrupt stops the line loop; the shared advisory lock is
    released after the read (tests/test_aux.py)."""
    f = tmp_path / "pts.txt"
    f.write_text("\n".join(f"P{i} {i} {i} {i}" for i in range(100)))
    intr = TR.ReadInterrupt()
    intr.interrupt()
    assert TR.read_object_coordinates_flat(f, interrupt=intr) == {}
    intr = TR.ReadInterrupt()
    seen = []
    for line in TR._read_lines(f, "#", intr):
        seen.append(line)
        if len(seen) == 5:
            intr.interrupt()
    assert len(seen) == 5
    import fcntl
    with open(f) as fh:
        fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        fcntl.flock(fh.fileno(), fcntl.LOCK_UN)


def test_report_wrapper_runs_on_the_card_by_default(network):
    base, _ = network
    if torch.cuda.is_available():
        adj, _ = TR.read_aicon_report(base + ".txt")
        assert adj.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.read_aicon_report(base + ".txt")
    adj, reader = TR.read_aicon_report(base + ".txt", device=CPU)
    assert adj.device.type == "cpu" and adj.cameras == list(
        reader.cameras.values())


# ---- writers ---------------------------------------------------------------

SCENE = dict(num_points=30, num_images=6, noise=5e-4, sigma=5e-4,
             perturb=0.01, seed=3)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """.info / .cxx / .mat of the JAX and the port's REDUCED estimates, and
    the port scale class's .info (through its result-writer hook)."""
    from bundle_adjustment_tpu_torch import ScaleBundleAdjustment

    d = tmp_path_factory.mktemp("exports")
    out = {}
    for side in ("jax", "port", "scale"):
        make = j_scene if side == "jax" else make_synthetic_scene
        cams, bars, _ = make(**SCENE)
        if side == "jax":
            adj, mi, W = JBA(), JMI, JW
        else:
            cls = BundleAdjustment if side == "port" else ScaleBundleAdjustment
            adj, mi, W = cls(device=CPU), MatrixInversion, TW
        adj.add(*cams, *bars)
        adj.set_invert_normal_equation(mi.REDUCED)
        base = str(d / side)
        events = []
        adj.add_property_change_listener(lambda n, o, v: events.append(n))
        if side == "scale":
            adj.set_adjustment_result_writer(W.DefaultResultWriter(base))
        assert int(adj.estimate_model()) == 1
        if side != "scale":
            W.DefaultResultWriter(base).export(adj)
            W.MatlabResultWriter(base).export(adj)
        else:
            assert "EXPORT_ADJUSTMENT_RESULTS" in events
        out[side] = base
    return out


def _info(base):
    with open(base + ".info") as fh:
        rows = [line.split("\t") for line in fh.read().splitlines()]
    return ([(r[0], r[1], int(r[3])) for r in rows],
            np.array([float(r[2]) for r in rows]))


def _corr_err(a, b):
    """max |a - b| in the correlation scale of b."""
    s = np.sqrt(np.abs(np.diagonal(b)))
    return float(np.abs((a - b) / s[:, None] / s[None, :]).max())


def test_info_and_cxx_match_jax(exports):
    kj, vj = _info(exports["jax"])
    kt, vt = _info(exports["port"])
    assert kt == kj
    assert np.abs(vt - vj).max() <= 1e-9 * np.abs(vj).max()
    cj = np.loadtxt(exports["jax"] + ".cxx")
    ct = np.loadtxt(exports["port"] + ".cxx")
    n = sum(k[2] >= 0 for k in kj)
    assert ct.shape == cj.shape == (n, n)
    assert _corr_err(ct, cj) <= 1e-7


def test_mat_matches_jax(exports):
    mj = sio.loadmat(exports["jax"] + ".mat")
    mt = sio.loadmat(exports["port"] + ".mat")
    assert set(mt) == set(mj)
    for k in ("degree_of_freedom", "number_of_observations",
              "number_of_unknowns"):
        assert mt[k].item() == mj[k].item()
    for k in ("variance_of_unit_weight_prio", "variance_of_unit_weight_post"):
        np.testing.assert_allclose(mt[k], mj[k], rtol=2e-9)
    for rec in ("coordinates", "interior_orientations",
                "distortion_parameters"):
        rj, rt = mj[rec], mt[rec]
        assert rt.dtype.names == rj.dtype.names and rt.shape == rj.shape
        for name in rj.dtype.names:
            for a, b in zip(rt[name].ravel(), rj[name].ravel()):
                if a.dtype.kind in "iuU":
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9)
    assert _corr_err(mt["dispersion"], mj["dispersion"]) <= 1e-7


def test_scale_class_writer_export(exports):
    """The scale class exports through the result-writer hook: the same
    .info as the JAX dense solver (tests/test_scale_driver.py)."""
    kj, vj = _info(exports["jax"])
    ks, vs = _info(exports["scale"])
    assert ks == kj
    assert np.abs(vs - vj).max() < 1e-8
    assert os.path.exists(exports["scale"] + ".cxx")
