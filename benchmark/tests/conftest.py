"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the root of a checkout.  The repository's tests/conftest.py does not
apply here (it sets up JAX); nothing here imports JAX.  Tests marked
``cuda`` need an NVIDIA GPU and skip without one; they decide so inside
the test, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's card-only test")
    return torch.device("cuda", 0)


#: a network the CPU runs in seconds; every width as the configurations'
TINY = {"points": 1000, "images": 30, "views": 12}


def make_copy(dest: Path) -> Path:
    """A copy of the benchmark (``dest/benchmark``, ``dest/BENCHMARK.json``)
    with a tiny configuration and its two cells, ``tiny.adjust`` and
    ``tiny.covariance``, added as new files and entries.  Returns the
    copy's BENCHMARK.json."""
    import json
    import shutil

    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/ba100k.json").read_text())
    cfg.update(name="tiny", **TINY)
    (dest / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "test"})
    for mix, like in (("adjust", "ba100k.adjust"),
                      ("covariance", "ba100k.covariance")):
        cell = f"tiny.{mix}"
        spec["workloads"].append({"name": cell, "config": "tiny",
                                  "traffic": mix, "chips": 1,
                                  "why": "test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
        shutil.copy(ROOT / f"benchmark/checks/{like}.json",
                    dest / f"benchmark/checks/{cell}.json")
    out = dest / "BENCHMARK.json"
    out.write_text(json.dumps(spec, indent=1))
    return out


@pytest.fixture(scope="session")
def tiny_copy(tmp_path_factory) -> Path:
    return make_copy(tmp_path_factory.mktemp("bench"))


def rehearse(bench_file: Path, workload: str, seed=5, seconds=0.01, trace=0,
             device="cpu"):
    """The rest of a run after the look for a chip, on ``device`` (the
    CPU by default), in this process: (result, exit code)."""
    import time

    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import runner

    cell = cells.load(bench_file, workload, root=bench_file.parent /
                      "benchmark")
    run = runner.Run(cell, seed, seconds, trace, torch.device(device),
                     time.perf_counter())
    return runner.execute(run)
