"""The check that decides ``correct``, on the CPU at a small network: the
port's own answers pass it; an answer perturbed, an answer computed one
precision lower (the control), and runs with the timed path broken
underneath (a step that returns its state unchanged, half of the
observations left out, an answer altered where it is produced) fail it."""

import json

import numpy as np
import pytest
import torch

from benchmark.reference import bundle
from benchmark.tests.conftest import rehearse
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.parallel import cov_direct, refine


def _limits(copy, cell):
    return json.loads((copy.parent / f"benchmark/checks/{cell}.json")
                      .read_text())


def _job(copy, cell, seed=5):
    import time

    from benchmark.harness import cell as cells
    from benchmark.harness import runner

    c = cells.load(copy, cell, root=copy.parent / "benchmark")
    run = runner.Run(c, seed, 0.0, 0, torch.device("cpu"),
                     time.perf_counter())
    job = c.job.Job(run)
    job.inputs()
    return job


@pytest.mark.parametrize("cell", ["tiny.adjust", "tiny.covariance"])
def test_port_passes(tiny_copy, cell):
    result, code = rehearse(tiny_copy, cell)
    assert code == 0 and result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    assert list(result)[-1] == "checks"


def test_adjust_perturbed_and_control_fail(tiny_copy):
    job = _job(tiny_copy, "tiny.adjust")
    limits = _limits(tiny_copy, "tiny.adjust")
    ref = job.reference()
    x = tuple(a.clone() for a in ref.state)
    assert all(v <= limits[k] for k, v in job.compare([x], ref).items())
    x[0][7, 1] += 1e-2
    bad = job.compare([x], ref)
    assert bad["state_gap"] > limits["state_gap"]
    assert any(v > limits[k] for k, v in job.control().items())


def test_adjust_nan_answer_fails(tiny_copy):
    job = _job(tiny_copy, "tiny.adjust")
    ref = job.reference()
    x = tuple(a.clone() for a in ref.state)
    x[1][0, 0] = float("nan")
    assert job.compare([x], ref)["state_gap"] == float("inf")


def test_covariance_perturbed_and_control_fail(tiny_copy):
    job = _job(tiny_copy, "tiny.covariance")
    limits = _limits(tiny_copy, "tiny.covariance")
    Q = job.reference()
    assert job.compare([Q.clone()], Q)["cov_gap"] == 0.0
    bad = Q.clone()
    bad[11] *= 1.0 + 1e-2
    assert job.compare([bad], Q)["cov_gap"] > limits["cov_gap"]
    assert job.control()["cov_gap"] > limits["cov_gap"]


# ---- the timed path broken underneath -----------------------------------

def _unchanged_step(self, s, **kw):
    """A refinement step that returns its state unchanged."""
    return s, torch.zeros(()), torch.zeros((), dtype=torch.float64), 0


def _half_left_out(orig):
    """The problem as the port gets it with half of the observations left
    out (weight 0): every second view of each point."""
    def upload(problem, device, dtype=torch.float32):
        w = np.array(problem.obs_weight)
        w[1::2] = 0.0
        return orig(problem._replace(obs_weight=w), device, dtype)
    return upload


def _altered_state(orig):
    """The refinement's answer with one coordinate moved by 1e-2."""
    def converge(*a, **kw):
        s, rec = orig(*a, **kw)
        lo = s.lo.points.clone()
        lo[7, 1] += 1e-2
        return s._replace(lo=s.lo._replace(points=lo)), rec
    return converge


def _altered_blocks(orig):
    def cov_all(*a, **kw):
        Q = orig(*a, **kw)
        Q[11] *= 1.0 + 1e-2
        return Q
    return cov_all


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_adjust_faults_fail(tiny_copy, monkeypatch, fault):
    if fault == "unchanged":
        monkeypatch.setattr(refine.Refiner, "step", _unchanged_step)
    elif fault == "half":
        monkeypatch.setattr(convert, "problem_to_torch",
                            _half_left_out(convert.problem_to_torch))
    else:
        monkeypatch.setattr(refine, "converge",
                            _altered_state(refine.converge))
    result, code = rehearse(tiny_copy, "tiny.adjust")
    assert code == 0 and not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_covariance_faults_fail(tiny_copy, monkeypatch, fault):
    if fault == "half":
        monkeypatch.setattr(convert, "problem_to_torch",
                            _half_left_out(convert.problem_to_torch))
    else:
        monkeypatch.setattr(cov_direct, "cov_all",
                            _altered_blocks(cov_direct.cov_all))
    result, code = rehearse(tiny_copy, "tiny.covariance")
    assert code == 0 and not result["correct"], result["checks"]


def test_reference_gauss_newton_is_stationary(tiny_copy):
    """The reference's optimum: a further Gauss-Newton step from it is
    below the tolerance it stopped at."""
    job = _job(tiny_copy, "tiny.adjust")
    ref = job.reference()
    again = bundle.gauss_newton(job.reference_net(torch.float64), ref.state,
                                tolerance=0.0, max_steps=1)
    assert again.max_dx[0] < 1e-8
