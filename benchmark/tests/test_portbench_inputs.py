"""The frozen generator gives the port's `synthetic` arrays bit for bit:
the network of `build_problem`, the start law and the image noise of
`scenario_batch`."""

import numpy as np
import pytest

from benchmark.inputs import network
from bundle_adjustment_tpu_torch import synthetic
from bundle_adjustment_tpu_torch.models.problem import ParamState
from bundle_adjustment_tpu_torch.parallel.rcs import RCSProblem


def _digest(net):
    return synthetic.digest(RCSProblem(**net.problem_fields()),
                            ParamState(**net.state_fields()))


@pytest.mark.parametrize("shape,seed", [
    ((2000, 40, 12), 3),
    ((1000, 200, 12), 2 ** 31 + 17),     # a seed over 32 signed bits
    ((100000, 500, 12), 2147483700),     # the adjust cells' geometry
])
def test_build_matches_build_problem(shape, seed):
    net = network.build(*shape, seed)
    assert _digest(net) == synthetic.digest(
        *synthetic.build_problem(*shape, seed=seed)[:2])


def test_truth_fields():
    net = network.build(1000, 20, 12, 9)
    ph, sh, _ = synthetic.build_problem(1000, 20, 12, seed=9)
    np.testing.assert_array_equal(net.points_true,
                                  synthetic.true_points(1000, seed=9))
    np.testing.assert_array_equal(net.eo_true, synthetic.true_eo(20))
    t = net.truth_fields()
    assert t["points"].shape == (ph.num_points, 3)
    np.testing.assert_array_equal(t["io"], sh.io)
    np.testing.assert_array_equal(t["dist"], sh.dist)


@pytest.mark.parametrize("seed", [5, 3000000017])
def test_starts_and_noise_match_scenario_batch(seed):
    P, M, V, S = 1000, 40, 12, 3
    net = network.build(P, M, V, seed)
    _, xys, _, states, _ = synthetic.scenario_batch(S, P, M, V, seed=seed)
    for s in range(S):
        pts, eo = network.job_start(net, seed, s)
        np.testing.assert_array_equal(pts, states.points[s])
        np.testing.assert_array_equal(eo, states.eo[s])
        np.testing.assert_array_equal(network.scenario(net, s).obs_xy,
                                      xys[s])


def test_same_seed_same_inputs():
    a, b = network.build(700, 20, 12, 11), network.build(700, 20, 12, 11)
    assert _digest(a) == _digest(b)
    assert _digest(network.build(700, 20, 12, 12)) != _digest(a)
