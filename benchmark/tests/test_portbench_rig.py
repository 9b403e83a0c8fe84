"""The rig cell's pieces on the CPU: the frozen rig generator against the
port's `synthetic.build_problem(num_cameras=C)` bit for bit, the rig
reference against the one-camera reference, and the rig check at 1,000
points / 20 images / 4 cameras: the port passes it; the float32 control,
an answer moved by 1e-2 and a refinement that returns its state
unchanged fail it."""

import json
import shutil

import pytest
import torch

from benchmark.inputs import network, rig as rig_inputs
from benchmark.reference import bundle, rig
from benchmark.tests.conftest import ROOT, rehearse
from bundle_adjustment_tpu_torch import synthetic
from bundle_adjustment_tpu_torch.models.problem import ParamState
from bundle_adjustment_tpu_torch.parallel import refine
from bundle_adjustment_tpu_torch.parallel.rcs import RCSProblem

CELL = "tinyrig.adjust_rig"
#: the rig cell's configuration cut to a network the CPU runs in seconds
TINY_RIG = {"points": 1000, "images": 20, "views": 12}


def _digest(net):
    return synthetic.digest(RCSProblem(**net.problem_fields()),
                            ParamState(**net.state_fields()))


@pytest.mark.parametrize("shape,seed", [((1000, 20, 12), 0),
                                        ((2000, 40, 12), 2 ** 31 + 17)])
def test_rig_build_matches_build_problem(shape, seed):
    net = rig_inputs.build(*shape, seed, 4)
    assert _digest(net) == synthetic.digest(
        *synthetic.build_problem(*shape, seed=seed, num_cameras=4)[:2])
    assert net.io.shape == (4, 3) and net.free_global.shape == (40,)


def test_rig_of_one_camera_is_the_network():
    assert _digest(rig_inputs.build(700, 20, 12, 11, 1)) \
        == _digest(network.build(700, 20, 12, 11))


def test_rig_reference_of_one_camera_is_the_reference():
    """With C = 1 the rig reference gives `bundle`'s optimum and Omega."""
    net = network.build(400, 12, 12, 3)
    xy = net.obs_xy.astype("float32").astype("float64")
    args = (net.free_point, net.real_points, net.point_uniform,
            net.num_images, net.r0[0], torch.device("cpu"), torch.float64)
    start = bundle.make_state(net.points_true, net.eo_true, net.io,
                              net.dist, torch.device("cpu"), torch.float64)
    a = bundle.gauss_newton(bundle.make_net(xy, net.obs_image, *args),
                            start, tolerance=1e-8)
    b = rig.gauss_newton(rig.make_net(xy, net.obs_image, net.cam_of_image,
                                      *args), start, tolerance=1e-8)
    assert a.steps == b.steps
    for u, v in zip(a.state, b.state):
        assert float((u - v).abs().max()) <= 1e-12
    assert abs(a.omega - b.omega) <= 1e-12 * a.omega


def _rig_copy(dest):
    """A copy of the benchmark with the rig configuration cut to
    `TINY_RIG` and its cell ``tinyrig.adjust_rig`` as new files and
    entries."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/ba100k_rig4.json")
                     .read_text())
    cfg.update(name="tinyrig", **TINY_RIG)
    (dest / "benchmark/configs/tinyrig.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tinyrig", "source": "test",
                            "file": "benchmark/configs/tinyrig.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "tinyrig",
                              "traffic": "adjust_rig", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ba100k_rig4.adjust" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    shutil.copy(ROOT / "benchmark/checks/ba100k_rig4.adjust.json",
                dest / f"benchmark/checks/{CELL}.json")
    out = dest / "BENCHMARK.json"
    out.write_text(json.dumps(spec, indent=1))
    return out


@pytest.fixture(scope="module")
def rig_copy(tmp_path_factory):
    return _rig_copy(tmp_path_factory.mktemp("rigbench"))


def _job(copy):
    import time

    from benchmark.harness import cell as cells
    from benchmark.harness import runner

    c = cells.load(copy, CELL, root=copy.parent / "benchmark")
    run = runner.Run(c, 5, 0.0, 0, torch.device("cpu"), time.perf_counter())
    job = c.job.Job(run)
    job.inputs()
    return job


def _limits(copy):
    return json.loads((copy.parent / f"benchmark/checks/{CELL}.json")
                      .read_text())


def test_port_passes_the_rig_check(rig_copy):
    """A traced rehearsal: every job converges, the answers pass, and the
    refinement's f64 share and its CG read from the port's spans."""
    result, code = rehearse(rig_copy, CELL, trace=1)
    assert code == 0 and result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    m = result["metrics"]
    assert 0 < m["refine_f64_share"]["value"] <= 100
    assert m["cg_per_adjust"]["value"] > 0


def test_rig_moved_answer_and_control_fail(rig_copy):
    job = _job(rig_copy)
    limits = _limits(rig_copy)
    ref = job.reference()
    x = tuple(a.clone() for a in ref.state)
    assert all(v <= limits[k] for k, v in job.compare([x], ref).items())
    x[0][7, 1] += 1e-2
    assert job.compare([x], ref)["state_gap"] > limits["state_gap"]
    assert any(v > limits[k] for k, v in job.control().items())


def _unchanged_step(self, s, **kw):
    """A refinement step that returns its state unchanged."""
    return s, torch.zeros(()), torch.zeros((), dtype=torch.float64), 0


def test_rig_unchanged_refinement_fails(rig_copy, monkeypatch):
    monkeypatch.setattr(refine.Refiner, "step", _unchanged_step)
    result, code = rehearse(rig_copy, CELL)
    assert code == 0 and not result["correct"], result["checks"]
