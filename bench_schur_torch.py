#!/usr/bin/env python3
"""The port's `bench_schur.py`: f32 `ops.schur.reduce_eo` (the batched
EO-block Schur complement) on one GPU, GFLOP/s under `bench_schur.py`'s
JSON line.

    python bench_schur_torch.py [nR M]       (default 4096 1024)

Runs on cuda:0; ``BENCH_CPU=1`` runs it on the CPU.  See
`bundle_adjustment_tpu_torch/bench.py` (`schur_main`).
"""

import sys

from bundle_adjustment_tpu_torch.bench import schur_main as main

if __name__ == "__main__":
    sys.exit(main())
