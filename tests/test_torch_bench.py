"""The port's benchmark (`bundle_adjustment_tpu_torch/bench.py`, the root
scripts `bench_torch.py` and `bench_schur_torch.py`) against the JAX
`bench.py` / `bench_schur.py` on the CPU.

* One module fixture runs the JAX `bench.run_suite(1024, 16, 12)` and the
  port's `run_suite` at the same size on the CPU (damping 1e-7 in the
  refinement, as the JAX bench; one repeat): the port's record holds every
  key of the JAX record, follows the same platform rule for the
  ``_pallas`` / plain keys, converges to max|dx| <= 1e-6 within one LM
  iteration of JAX's count and factors the same n.
* `bench_torch.main` in-process (``BENCH_CPU=1``, 256 / 8 / 6): the last
  line is the record under `bench.py`'s metric name; with `cov_all`
  raising, the run exits 1 and its record carries ``cov_error``.
* `run_mesh_suite` on two gloo ranks on the CPU.
* `bench_schur_torch`: `reduce_eo`'s S against the JAX `reduce_eo` (f64),
  the flops count of `bench_schur.py`, and the JSON line.
"""

import json

import numpy as np
import pytest
import torch

import bench
import bench_schur_torch
import bench_torch
from bundle_adjustment_tpu_torch import bench as tbench

SHAPE = (1024, 16, 12)
TINY = ["256", "8", "6"]
TOL = 1e-6
THREADS = 2   # the suite's workers share the cores


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def records():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        port = tbench.run_suite(*SHAPE, device="cpu", refine_damping=1e-7,
                                repeats=1)
    finally:
        torch.set_num_threads(n)
    return bench.run_suite(*SHAPE, full=True), port


def test_the_port_records_every_key_of_the_jax_bench(records):
    jax_rec, port = records
    assert len(jax_rec) == 20, sorted(jax_rec)
    assert not set(jax_rec) - set(port), sorted(set(jax_rec) - set(port))
    assert not tbench.failed(port), port
    for key in ("refine_damping", "cov_dtype", "spread", "card", "device"):
        assert key in port
    assert port["cov_dtype"] == "float64"
    assert port["device"] == port["card"] == "cpu"


def test_the_platform_rule_of_the_kernel_keys(records):
    """Off the card neither package has a kernel key: the fixed-cg8 rate
    and the matvec are the plain route's."""
    for rec in records:
        assert not [k for k in rec if "pallas" in k or "read_floor" in k]
        assert "lm_it_per_s_fixed_cg8" in rec
        assert "matvec_xla_gbps" in rec and "matvec_hbm_sol_fraction" in rec


def test_convergence_and_cholesky_as_the_jax_bench(records):
    jax_rec, port = records
    assert abs(port["lm_iterations_to_converge"]
               - jax_rec["lm_iterations_to_converge"]) <= 1
    assert jax_rec["converged_max_dx"] <= TOL
    assert port["converged_max_dx"] <= TOL
    assert port["tp_cholesky_n"] == jax_rec["tp_cholesky_n"] == 4096
    for key in ("time_to_converged_s", "lm_it_per_s_fixed_cg8",
                "cov_all_points_s", "xla_cholesky_gflops",
                "tp_cholesky_gflops", "chip_matmul_tflops"):
        assert np.isfinite(port[key]) and port[key] > 0, key
    assert port["cov_point_blocks_per_s"] == pytest.approx(
        1024 / port["cov_all_points_s"])
    assert set(port["cov_stage_s"]) == set(tbench.COV_STAGES)


def _last_record(out: str) -> dict:
    lines = [ln for ln in out.strip().splitlines() if ln.startswith("{")]
    return json.loads(out.strip().splitlines()[-1]), lines


def test_main_prints_the_record_last(monkeypatch, capsys, few_threads):
    monkeypatch.setenv("BENCH_CPU", "1")
    assert bench_torch.main(TINY) == 0
    rec, lines = _last_record(capsys.readouterr().out)
    assert rec["metric"] == "lm_iterations_per_s_256pts_8img_fixed_cg8"
    assert rec["phase"] == "complete" and len(lines) >= 2
    assert rec["value"] == rec["lm_it_per_s_fixed_cg8"]
    assert rec["refine_damping"] == 0.0 and rec["cov_dtype"] == "float64"
    # three repeats: every repeated key has its [min, max] around the median
    assert rec["spread"]
    for key, (lo, hi) in rec["spread"].items():
        assert lo <= rec[key] <= hi, key
    assert rec["converged_max_dx"] <= TOL
    assert rec["vs_baseline"] == pytest.approx(
        rec["value"] / tbench.java_iter_per_s(256))
    assert "config5_1m_points" not in rec


def test_a_failed_phase_exits_non_zero(monkeypatch, capsys, few_threads):
    def broken(*a, **k):
        raise RuntimeError("cov_all broken on purpose")

    def quick(dev, repeats):  # stand-in for the fixed-size timings
        return [1.0] * repeats, [1.0] * repeats

    monkeypatch.setenv("BENCH_CPU", "1")
    monkeypatch.setattr(tbench.cov_direct, "cov_all", broken)
    monkeypatch.setattr(tbench, "health", quick)
    monkeypatch.setattr(tbench, "cholesky_times", quick)
    assert bench_torch.main(TINY) == 1
    rec, _ = _last_record(capsys.readouterr().out)
    assert "cov_all broken on purpose" in rec["cov_error"]
    assert "cov_all_points_s" not in rec
    # the phases after it still ran
    assert rec["tp_cholesky_n"] == 4096


def test_main_raises_without_a_card_unless_asked(monkeypatch):
    monkeypatch.delenv("BENCH_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        tbench.run_suite(*SHAPE)
    with pytest.raises(RuntimeError, match="cpu"):
        bench_schur_torch.main(["64", "16"])


def test_mesh_suite_on_two_cpu_ranks():
    out = tbench.run_mesh_suite(2, 256, 8, 6, device="cpu")
    assert out["mesh_platform"] == "cpu x 2, gloo"
    for key in ("mesh_lm_it_per_s_fixed_cg8", "mesh_matvec_ms",
                "mesh_matvec_agg_gbps", "mesh_compile_s"):
        assert np.isfinite(out[key]) and out[key] > 0, key


def test_schur_matches_the_jax_reduce_eo():
    import jax.numpy as jnp

    from bundle_adjustment_tpu.ops.schur import reduce_eo

    nR, M = 64, 16
    N, n, col_eo = tbench.schur_system(nR, M, torch.float64, "cpu")
    got = tbench.schur_reduce(N, n, col_eo, nR)
    ref = reduce_eo(jnp.asarray(N.numpy()), jnp.asarray(n.numpy()),
                    jnp.asarray(col_eo.numpy().astype(np.int32)), nR)
    np.testing.assert_allclose(got.S.numpy(), np.asarray(ref.S), rtol=1e-10)
    np.testing.assert_allclose(got.nr.numpy(), np.asarray(ref.nr),
                               rtol=1e-10)


@pytest.mark.parametrize("nR, M", [(4096, 1024), (64, 16)])
def test_schur_flops_are_bench_schurs(nR, M):
    """`bench_schur.py:56-58`: the S update, the W products and the 6x6
    inverses."""
    assert tbench.schur_flops(nR, M) == (2 * nR * nR * 6 * M
                                         + 2 * nR * M * 36 + 2 * M * 216)


def test_schur_main_prints_its_line(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_CPU", "1")
    assert bench_schur_torch.main(["64", "16"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "schur_gflops_per_chip_nr64_m16"
    assert rec["unit"] == "GFLOP/s" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 2.0)
    assert rec["device"] == "cpu"
