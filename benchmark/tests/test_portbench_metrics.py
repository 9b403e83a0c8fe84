"""The benchmark's metric arithmetic, pinned against the port's `measure`
as the benchmark copied it; the harness finding a configuration, a mix
and a metric that are new files only; and, on a card, a whole traced
run of a small cell."""

import json
import os
import random
import subprocess
import sys

import pytest

from benchmark.harness import cell as cells
from benchmark.harness import timeline, work
from benchmark.tests.conftest import ROOT, make_copy, rehearse
from bundle_adjustment_tpu_torch import measure

SHAPES = [(1204224, 100352, 500, 10, 12),      # ba100k, packed rows
          (12005376, 1000448, 5000, 10, 12),   # ba1m
          (12288, 1024, 40, 10, 12), (4096, 512, 16, 16, 8)]


@pytest.mark.parametrize("N,P,M,G,V", SHAPES)
def test_work_counts_as_the_port(N, P, M, G, V):
    assert work.k1_work(N, P, M, G, V) == measure.k1_work(N, P, M, G, V)
    assert work.k2_work(N, P, M, G, V) == measure.k2_work(N, P, M, G, V)
    assert work.matvec_flops(N, G, V) == measure.matvec_cost(N, G, V)[0]
    assert work.matvec_rows_read(N, G) == measure.matvec_rows_read(N, G)
    for w in (work.k1_work(N, P, M, G, V), work.k2_work(N, P, M, G, V)):
        assert work.bound_ms(w) == measure.bound_ms(w)
    assert (work.HBM_BYTES_PER_S, work.F32_FLOPS_PER_S) == (
        measure.HBM_BYTES_PER_S, measure.F32_FLOPS_PER_S)


def test_k1_bound_at_the_cells():
    """K1 at ba100k moves 204.7 MB: 0.0611 ms at 3.35 TB/s."""
    ms, by = work.bound_ms(work.k1_work(*SHAPES[0]))
    assert by == "bytes" and abs(ms - 0.0611) < 5e-4


def _brute(intervals, lo, hi):
    cover = [False] * (hi - lo)
    for s, e in intervals:
        for t in range(max(s, lo), min(e, hi)):
            cover[t - lo] = True
    return sum(cover)


@pytest.mark.parametrize("seed", range(5))
def test_union_and_gaps(seed):
    rng = random.Random(seed)
    iv = [(s, s + rng.randint(1, 30)) for s in
          (rng.randint(-20, 300) for _ in range(40))]
    lo, hi = 0, 320
    u = timeline.union_s(iv, lo, hi)
    assert u == _brute(iv, lo, hi)
    assert sum(e - s for s, e in timeline.gaps(iv, lo, hi)) == hi - lo - u


def test_union_is_the_port_sum_without_overlap():
    """Where device activities do not overlap (one stream), the union is
    the sum `measure.device_profile` takes for busy."""
    iv = [(0, 5), (7, 9), (20, 31)]
    assert timeline.union_s(iv, 0, 40) == sum(e - s for s, e in iv)


def test_reduce_events_names_idle_gaps():
    ev = [("k1", True, 10, 20), ("k2", True, 15, 30),
          ("cudaLaunchKernel", False, 30, 40), ("k3", True, 50, 60),
          ("cudaStreamSynchronize", False, 60, 70)]
    p = timeline.reduce_events(ev, 0, 80)
    assert p.busy_s == 30e-9 and p.window_s == 80e-9
    assert dict(p.idle_gaps) == {"cudaLaunchKernel": 20e-9,
                                 "cudaStreamSynchronize": 20e-9,
                                 "host": 10e-9}
    assert p.device_ops[0] == ["k2", 15e-9]


def test_every_metric_has_a_reader():
    """Each metric of BENCHMARK.json finds its reader: a file of its own,
    or that of the quantity it splits by cell or job (``cov_s.ba1m``,
    ``device_idle.adjust``)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = ROOT / "benchmark"
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert cells.reader_path(b, m["name"]).exists(), m["name"]
    assert cells.reader_path(b, "cov_s.ba1m") == b / "metrics/cov_s.py"
    for name in ("device_idle.cov.ba1m", "device_idle.adjust"):
        assert cells.reader_path(b, name) == b / "metrics/device_idle.py"


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files (and entries) run without an edit to any file there was; a CPU
    rehearsal reports the CPU and writes no device metric."""
    bench = make_copy(tmp_path)
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs/tiny.json").read_text())
    cfg.update(name="tiny2", points=600, images=24)
    (b / "configs/tiny2.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic/adjust.json").read_text())
    mix["starts"] = 2
    (b / "traffic/adjust_two.json").write_text(json.dumps(mix))
    (b / "metrics/jobs_done.py").write_text(
        "def read(run):\n    return len(run.completed())\n")
    (b / "checks/tiny2.adjust_two.json").write_text(
        (b / "checks/tiny.adjust.json").read_text())
    spec = json.loads(bench.read_text())
    spec["configs"].append({"name": "tiny2", "source": "test",
                            "file": "benchmark/configs/tiny2.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny2.adjust_two", "config": "tiny2",
                              "traffic": "adjust_two", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "jobs_done", "unit": "count",
                              "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "adjust_s",
                              "workloads": ["tiny2.adjust_two"]})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ba100k.adjust" in m.get("workloads", ()):
            m["workloads"].append("tiny2.adjust_two")
    bench.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, str(b / "run.py"), "--workload", "tiny2.adjust_two",
         "--seed", "3000000001", "--seconds", "0.01", "--trace", "1",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["jobs_done"]["value"] >= 1
    assert res["device"]["platform"] == "cpu"
    sources = {m["name"]: m["source"] for m in spec["per_layer"]}
    assert not [m for m in res["metrics"] if sources[m] == "device_trace"]
    assert list(res)[-1] == "checks"


def test_no_card_no_result(tmp_path):
    """Without a CUDA device (this CPU) a run exits 2 and prints no
    result; in a directory with the benchmark alone it fails too."""
    import torch

    make_copy(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, str(tmp_path / "benchmark/run.py"),
             "--workload", "tiny.adjust", "--seed", "1", "--seconds", "1"],
            capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=300)
        assert out.returncode == 2 and not out.stdout.strip()
    out = subprocess.run(
        [sys.executable, str(tmp_path / "benchmark/run.py"),
         "--workload", "tiny.adjust", "--seed", "1", "--seconds", "1",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.adjust", "tiny.covariance"])
def test_traced_run_on_the_card(cuda_device, tiny_copy, cell):
    result, code = rehearse(tiny_copy, cell, trace=1, device="cuda")
    assert code == 0 and result["correct"], result["checks"]
    d = result["device"]
    assert d["platform"] == "gpu" and 0 < d["busy_s"] <= d["window_s"]
    assert result["breakdown"]["device_ops"]
    for name, m in result["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 100
