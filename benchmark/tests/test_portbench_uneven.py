"""The uneven-visibility cell's pieces on the CPU: the frozen thinning
against the port's `synthetic.thin_views` bit for bit (and its noise and
starts against `synthetic.thin_scenarios`), the reference by view count
against the one-view-count reference, and the check at 1,000 points /
30 images (64 views cut to 12, every 100th point keeping all 64): the
port passes it through its file-order route; an answer moved by 1e-2,
the float32 control and a refinement that returns its state unchanged
fail it."""

import json
import shutil

import numpy as np
import pytest
import torch

from benchmark.inputs import network, uneven as uneven_inputs
from benchmark.reference import bundle, uneven
from benchmark.tests.conftest import ROOT, rehearse
from bundle_adjustment_tpu_torch import synthetic
from bundle_adjustment_tpu_torch.models.problem import ParamState
from bundle_adjustment_tpu_torch.parallel import refine
from bundle_adjustment_tpu_torch.parallel.rcs import RCSProblem

CELL = "tinyuneven.adjust"
CONFIG = "benchmark/configs/ba100k_uneven.json"
#: the cell's configuration cut to a network the CPU runs in seconds
TINY = {"points": 1000, "images": 30}
CPU = torch.device("cpu")


def _digest(net):
    return synthetic.digest(RCSProblem(**net.problem_fields()),
                            ParamState(**net.state_fields()))


@pytest.mark.parametrize("shape,kept,every,seed", [
    ((2000, 40, 24), 6, 20, 3),
    ((1000, 30, 64), 12, 100, 2 ** 31 + 17),
    ((100000, 500, 64), 12, 100, 2147483700),    # the cell's network
])
def test_thin_matches_thin_views(shape, kept, every, seed):
    net = uneven_inputs.thin(network.build(*shape, seed), kept, every)
    ph, sh = synthetic.thin_views(
        *synthetic.build_problem(*shape, seed=seed)[:2], views=kept,
        every=every)
    assert _digest(net) == synthetic.digest(ph, sh)
    assert net.point_uniform is None and net.num_points == shape[0]


def test_noise_and_starts_match_thin_scenarios():
    P, M, V, S, seed = 1000, 30, 64, 3, 7
    full = network.build(P, M, V, seed)
    batch = synthetic.scenario_batch(S, P, M, V, seed=seed)
    problem, xys, _, states = synthetic.thin_scenarios(
        batch[0], batch[1], batch[2], batch[3], views=12, every=100)
    for s in range(S):
        pts, eo = uneven_inputs.job_start(full, seed, s)
        np.testing.assert_array_equal(pts, states.points[s])
        np.testing.assert_array_equal(eo, states.eo[s])
        net = uneven_inputs.thin(network.scenario(full, s), 12, 100)
        np.testing.assert_array_equal(net.obs_xy, xys[s])
        np.testing.assert_array_equal(net.obs_point, problem.obs_point)


def test_reference_of_uniform_views_is_the_reference():
    """On a network whose every point has the same views, in point-major
    order, the reference by view count gives `bundle`'s optimum and
    Omega, 0 apart."""
    net = network.build(400, 12, 12, 3)
    n = net.real_points * net.point_uniform
    xy = net.obs_xy.astype("float32").astype("float64")
    start = bundle.make_state(net.points_true, net.eo_true, net.io,
                              net.dist, CPU, torch.float64)
    a = bundle.gauss_newton(bundle.make_net(
        xy, net.obs_image, net.free_point, net.real_points,
        net.point_uniform, net.num_images, net.r0[0], CPU, torch.float64),
        start, tolerance=1e-8)
    b = uneven.gauss_newton(uneven.make_net(
        xy[:n], net.obs_image[:n], net.obs_point[:n], net.free_point,
        net.real_points, net.num_images, net.r0[0], CPU, torch.float64),
        start, tolerance=1e-8)
    assert a.steps == b.steps and a.max_dx == b.max_dx
    for u, v in zip(a.state, b.state):
        assert torch.equal(u, v)
    assert a.omega == b.omega


def test_reference_takes_the_views_in_any_order():
    """The same points with their rows shuffled: the same optimum within
    f64 rounding (the sums run in another order)."""
    net = uneven_inputs.thin(network.build(600, 20, 24, 5), 6, 10)
    xy = net.obs_xy.astype("float32").astype("float64")
    start = bundle.make_state(net.points_true, net.eo_true, net.io,
                              net.dist, CPU, torch.float64)
    perm = np.random.default_rng(0).permutation(net.obs_xy.shape[0])
    res = [uneven.gauss_newton(uneven.make_net(
        xy[o], net.obs_image[o], net.obs_point[o], net.free_point,
        net.num_points, net.num_images, net.r0[0], CPU, torch.float64),
        start, tolerance=1e-8) for o in (np.arange(perm.shape[0]), perm)]
    assert len({V for V, _, _ in uneven.make_net(
        xy, net.obs_image, net.obs_point, net.free_point, net.num_points,
        net.num_images, net.r0[0], CPU, torch.float64).groups}) == 2
    for u, v in zip(res[0].state, res[1].state):
        assert float((u - v).abs().max()) <= 1e-9
    assert abs(res[0].omega / res[1].omega - 1) <= 1e-12


def _uneven_copy(dest):
    """A copy of the benchmark with the cell's configuration cut to
    `TINY` and its cell ``tinyuneven.adjust`` as new files and entries."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / CONFIG).read_text())
    cfg.update(name="tinyuneven", **TINY)
    (dest / "benchmark/configs/tinyuneven.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tinyuneven", "source": "test",
                            "file": "benchmark/configs/tinyuneven.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "tinyuneven",
                              "traffic": "adjust_uneven", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ba100k_uneven.adjust" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    shutil.copy(ROOT / "benchmark/checks/ba100k_uneven.adjust.json",
                dest / f"benchmark/checks/{CELL}.json")
    out = dest / "BENCHMARK.json"
    out.write_text(json.dumps(spec, indent=1))
    return out


@pytest.fixture(scope="module")
def uneven_copy(tmp_path_factory):
    return _uneven_copy(tmp_path_factory.mktemp("unevenbench"))


def _job(copy):
    import time

    from benchmark.harness import cell as cells
    from benchmark.harness import runner

    c = cells.load(copy, CELL, root=copy.parent / "benchmark")
    run = runner.Run(c, 5, 0.0, 0, CPU, time.perf_counter())
    job = c.job.Job(run)
    job.inputs()
    return job


def _limits(copy):
    return json.loads((copy.parent / f"benchmark/checks/{CELL}.json")
                      .read_text())


def test_port_passes_the_uneven_check(uneven_copy):
    """A traced rehearsal: every job converges on the file order, the
    answers pass, and the per-layer readers read the port's spans."""
    result, code = rehearse(uneven_copy, CELL, trace=1)
    assert code == 0 and result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    m = result["metrics"]
    assert m["cg_per_adjust"]["value"] > 0
    assert m["linearize_s"]["value"] > 0 and m["job_setup_s"]["value"] > 0
    assert m["cg_iter_ms"]["value"] > 0
    assert m["refine_f64_share"]["value"] == 0.0


def test_uneven_network_is_in_file_order(uneven_copy):
    job = _job(uneven_copy)
    net = job.net
    assert net.point_uniform is None and net.num_points == TINY["points"]
    counts = np.bincount(net.obs_point, minlength=net.num_points)
    assert set(counts.tolist()) == {12, 64}
    assert (np.diff(net.obs_image) >= 0).all()


def test_uneven_moved_answer_and_control_fail(uneven_copy):
    job = _job(uneven_copy)
    limits = _limits(uneven_copy)
    ref = job.reference()
    x = tuple(a.clone() for a in ref.state)
    assert all(v <= limits[k] for k, v in job.compare([x], ref).items())
    x[0][7, 1] += 1e-2
    assert job.compare([x], ref)["state_gap"] > limits["state_gap"]
    assert any(v > limits[k] for k, v in job.control().items())


def _unchanged_step(self, s, **kw):
    """A refinement step that returns its state unchanged."""
    return s, torch.zeros(()), torch.zeros((), dtype=torch.float64), 0


def test_uneven_unchanged_refinement_fails(uneven_copy, monkeypatch):
    monkeypatch.setattr(refine.Refiner, "step", _unchanged_step)
    result, code = rehearse(uneven_copy, CELL)
    assert code == 0 and not result["correct"], result["checks"]
