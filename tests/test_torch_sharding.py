"""The port's communicator (`parallel/sharding.py`) and multi-process set-up
(`parallel/multihost.py`) on CPU ranks (gloo, spawned).

Every `Comm` collective at 2 ranks in both forms (the direct collectives
and the forms built from `all_reduce`) against numpy, exactly: sums of two
float64 values and copies.  `pad_to_multiple` and `shard_observations`
against the JAX functions (the ranks' slices concatenated equal the JAX
padded arrays).  `multihost.initialize` (``env://``, as torchrun sets it),
`global_mesh`, `scenario_mesh` and `is_coordinator` at 2 ranks.  The rank
workers import torch, numpy and the port only.
"""

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch.parallel import multihost, sharding
from _torch_threads import one_torch_thread  # noqa: F401

FORMS = (sharding.DIRECT, sharding.ALL_REDUCE)
TIMEOUT = 90
SCENE = dict(num_points=23, num_images=5, noise=1e-4, sigma=1e-4, seed=61,
             with_scale_bar=False)


def _value(rank, shape):
    return torch.arange(np.prod(shape), dtype=torch.float64).reshape(
        shape) * (rank + 1) + 0.25 * rank


def _ops_worker(comm):
    from bundle_adjustment_tpu_torch.models.layout import assign_columns
    from bundle_adjustment_tpu_torch.models.problem import compile_problem
    from bundle_adjustment_tpu_torch.testing import make_synthetic_scene

    out = {}
    for form in FORMS:
        c = sharding.Comm(comm.group, "cpu", form=form)
        x = _value(c.rank, (4, 3))
        out[form] = dict(
            repr=repr(c), psum=c.psum(x), pmax=c.pmax(x),
            gather0=c.all_gather(x), gather1=c.all_gather(x, dim=1),
            scatter0=c.psum_scatter(x), scatter1=c.psum_scatter(
                _value(c.rank, (3, 4)), dim=1),
            bcast=c.broadcast(x, 1), scalar=c.psum(torch.tensor(c.rank + 0.5)))
    cameras, _, _ = make_synthetic_scene(**SCENE)
    cs = compile_problem(cameras, [], [], assign_columns(cameras, [], []))
    out["shard"] = sharding.shard_observations(cs.problem, comm)
    out["default_form"] = comm.form
    whole, first = sharding.make_mesh(), sharding.make_mesh(1)
    out["mesh"] = (whole.size, whole.rank,
                   None if first is None else (first.size, first.rank))
    return out


def _mesh_worker(comm):
    assert multihost.is_coordinator() == (comm.rank == 0)
    mesh = multihost.scenario_mesh(scenarios_per_host=2)
    one = torch.ones(1, dtype=torch.float64)
    return dict(rank=comm.rank, size=comm.size, device=str(comm.device),
                coordinator=multihost.is_coordinator(), shape=mesh.shape,
                scen=(mesh.scenario.rank, mesh.scenario.size),
                obs=(mesh.obs.rank, mesh.obs.size),
                scen_sum=float(mesh.scenario.psum(one * comm.rank)[0]),
                obs_sum=float(mesh.obs.psum(one * comm.rank)[0]),
                world=float(comm.psum(one)[0]))


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    return multihost.run_ranks(_ops_worker, 2, device="cpu", timeout=TIMEOUT,
                               workdir=tmp_path_factory.mktemp("ops"))


@pytest.mark.parametrize("form", FORMS)
def test_comm_ops_match_numpy(ops, form):
    xs = [_value(r, (4, 3)).numpy() for r in range(2)]
    ys = [_value(r, (3, 4)).numpy() for r in range(2)]
    total = xs[0] + xs[1]
    for r, res in enumerate(ops):
        got = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
               for k, v in res[form].items()}
        assert f"form={form}" in got["repr"] and f"rank={r}" in got["repr"]
        np.testing.assert_array_equal(got["psum"], total)
        np.testing.assert_array_equal(got["pmax"], np.maximum(*xs))
        np.testing.assert_array_equal(got["gather0"], np.concatenate(xs, 0))
        np.testing.assert_array_equal(got["gather1"], np.concatenate(xs, 1))
        np.testing.assert_array_equal(got["scatter0"],
                                      total[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["scatter1"],
                                      (ys[0] + ys[1])[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["bcast"], xs[1])
        assert float(got["scalar"]) == 2.0


def test_form_chosen_from_backend_and_device(ops):
    assert all(r["default_form"] == sharding.DIRECT for r in ops)
    # make_mesh: every rank, then the first rank alone (None elsewhere)
    assert [r["mesh"] for r in ops] == [(2, 0, (1, 0)), (2, 1, None)]
    assert sharding.collective_form("gloo", torch.device("cuda", 0)) \
        == sharding.ALL_REDUCE
    assert sharding.collective_form("gloo", torch.device("cpu")) \
        == sharding.DIRECT
    assert sharding.collective_form("nccl", torch.device("cuda", 0)) \
        == sharding.DIRECT


@pytest.mark.parametrize("n,m", [(0, 1), (7, 8), (8, 8), (9, 8), (100, 3)])
def test_pad_to_multiple_matches_jax(n, m):
    from bundle_adjustment_tpu.parallel import sharding as J

    assert sharding.pad_to_multiple(n, m) == J.pad_to_multiple(n, m)


def test_shard_observations_match_jax(ops):
    import jax
    import numpy as onp
    from jax.sharding import Mesh

    from bundle_adjustment_tpu.models.layout import assign_columns
    from bundle_adjustment_tpu.models.problem import compile_problem
    from bundle_adjustment_tpu.parallel import sharding as J
    from bundle_adjustment_tpu.testing import make_synthetic_scene

    cameras, _, _ = make_synthetic_scene(**SCENE)
    cs = compile_problem(cameras, [], [], assign_columns(cameras, [], []))
    mesh = Mesh(onp.array(jax.devices()[:2]), ("obs",))
    ref = J.shard_observations(cs.problem, mesh)
    assert cs.problem.num_image_obs % 2 == 1  # a pad row on the last rank
    for key, arr in ref.items():
        got = np.concatenate([r["shard"][key].numpy() for r in ops])
        np.testing.assert_array_equal(got, np.asarray(arr), err_msg=key)


def test_multihost_env_rendezvous(tmp_path):
    res = multihost.run_ranks(_mesh_worker, 2, device="cpu", timeout=TIMEOUT,
                              workdir=tmp_path, rendezvous="env")
    for r, out in enumerate(res):
        assert out["rank"] == r and out["size"] == 2
        assert out["device"] == "cpu" and out["coordinator"] == (r == 0)
        # one host: min(2 scenarios per host x 1 host, 2 ranks) = 2
        assert out["shape"] == (2, 1)
        assert out["scen"] == (r, 2) and out["obs"] == (0, 1)
        assert out["scen_sum"] == 1.0 and out["obs_sum"] == float(r)
        assert out["world"] == 2.0


def test_initialize_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.run_ranks(_mesh_worker, 2, workdir=tmp_path)
    assert not (tmp_path / "store").exists()
