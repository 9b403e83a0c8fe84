#!/usr/bin/env python3
"""The port's benchmark: `bench.py`'s measurements through
`bundle_adjustment_tpu_torch` on one GPU, under `bench.py`'s JSON keys.

    python bench_torch.py [P M V] [--mesh n]

No arguments: 100,000 points / 500 images / 12 views, then BASELINE config
5 (1,000,000 / 5,000 / 12) under ``config5_1m_points``.  Runs on cuda:0;
``BENCH_CPU=1`` runs the plain path on the CPU.  Provisional JSON lines
follow the phases; the last line is the record.  Exits 1 where a phase
failed (the record carries its ``*_error`` key).  See
`bundle_adjustment_tpu_torch/bench.py`.
"""

import sys

from bundle_adjustment_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
