"""Benchmark of bundle_adjustment_tpu_torch on one NVIDIA H100: one run of
one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Builds the cell's network from the seed,
hands it to the port, warms up the cell's own shapes (the CUDA kernels
build once into the checkout's ``.kernels_build/``), runs jobs one after
another for ``--seconds``, checks every answer against the plain
reference (`reference/`) and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``checks``: each number
compared with its limit, also printed as the last lines on standard
error.

Exits 2 without a CUDA device (or with fewer than the cell asks for) and
3 if the process holds JAX or the JAX package once the window has closed;
neither prints a result.  ``--device cpu`` rehearses a run on the CPU
(the kernels' plain versions; no device metric is written)."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: rehearse on the CPU (never a measurement)")
    return ap.parse_args(argv)


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None, t0=T0) -> int:
    args = parse(argv)
    from benchmark.harness import cell as cells
    from benchmark.harness import runner

    import torch

    cell = cells.load(ROOT / "BENCHMARK.json", args.workload)
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA device(s); "
                  f"torch.cuda sees {have}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    run = runner.Run(cell, args.seed, args.seconds, args.trace, device, t0)
    result, code = runner.execute(run)
    if result is None:
        return code
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    for c in result["checks"].values():
        c["value"] = _finite(c["value"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
