"""Benchmark of bundle_adjustment_tpu_torch on one NVIDIA H100.

Run from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

`BENCHMARK.json` at the root names the cells; everything that belongs to
one configuration, traffic mix, job kind, per-cell check or metric sits in
a file of its own under this folder and is found by its name
(`harness.cell`)."""
