"""The control of a cell's check: the plain reference computed one
precision below the configuration's (float32 for float64), put in the
program's place and judged by the same comparison, at the cell's own
size.  It has to come out not correct; its readings set the upper end of
each limit (`checks/<cell>.json`).  The benchmark's own runs do not run
it.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed ...]

One JSON line per seed: the numbers compared, each beside its limit."""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int, action="append")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import runner

    cell = cells.load(HERE.parent / "BENCHMARK.json", args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seed:
        t0 = time.perf_counter()
        run = runner.Run(cell, seed, 0.0, 0, device, t0)
        job = cell.job.Job(run)
        job.inputs()
        numbers = job.control()
        out = {"workload": cell.name, "seed": seed,
               "control": {k: {"value": v, "limit": cell.limits[k]}
                           for k, v in numbers.items()},
               "not_correct": any(not v <= cell.limits[k]
                                  for k, v in numbers.items()),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(out), flush=True)
        del job, run
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
