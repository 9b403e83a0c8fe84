"""A cell and everything it names, found by name.

`BENCHMARK.json` gives the cell's configuration and traffic mix.  The
configuration's file is the one its entry names; the mix is
``traffic/<mix>.json``; the mix names its job kind, ``jobs/<job>.py``;
the numbers the run compares and their limits are ``checks/<cell>.json``;
each metric is read by ``metrics/<metric>.py``, and a quantity split by
cell (``<quantity>.<part>``) without a file of its own by its quantity's
reader (`reader_path`).  A later change adds a
configuration, a mix, a job kind or a metric as new files only."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

#: the benchmark's folder
HERE = Path(__file__).resolve().parent.parent


class Metric(NamedTuple):
    name: str
    unit: str
    source: str
    reader: object      # the module with read(run)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # the configuration file's contents
    traffic: dict       # the mix's file
    job: object         # the job module
    limits: dict        # {number compared: limit}
    end_to_end: list    # [Metric] the cell reports with --trace 0
    per_layer: list     # [Metric] with --trace 1


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def reader_path(root: Path, name: str) -> Path:
    """``metrics/<name>.py``; where there is none, the reader of ``name``
    without its last ``.<part>``, and so on."""
    stem = name
    while True:
        path = root / "metrics" / f"{stem}.py"
        if path.exists() or "." not in stem:
            return path
        stem = stem.rsplit(".", 1)[0]


def _metrics(entries, cell: str, root: Path) -> list:
    """The metrics of ``entries`` that ``cell`` reports: those without a
    ``workloads`` list and those whose list names it."""
    out = []
    for m in entries:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        mod = load_module(reader_path(root, m["name"]),
                          "benchmark_metric_" + m["name"].replace(".", "_")
                          .replace("-", "_"))
        out.append(Metric(name=m["name"], unit=m["unit"],
                          source=m["source"], reader=mod))
    return out


def load(benchmark_file: Path, workload: str, root: Path = HERE) -> Cell:
    """The cell ``workload`` of ``benchmark_file``; ``root`` is the
    benchmark's folder (where the mixes, jobs, checks and metrics are).
    A configuration's ``file`` is relative to the benchmark file's folder
    (the checkout's root)."""
    spec = _read_json(benchmark_file)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark_file} "
                       f"(there are {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read_json(benchmark_file.parent / configs[w["config"]]["file"])
    traffic = _read_json(root / "traffic" / f"{w['traffic']}.json")
    job = load_module(root / "jobs" / f"{traffic['job']}.py",
                      "benchmark_job_" + traffic["job"])
    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=traffic, job=job,
        limits=_read_json(root / "checks" / f"{workload}.json"),
        end_to_end=_metrics(spec["end_to_end"], workload, root),
        per_layer=_metrics(spec["per_layer"], workload, root))
