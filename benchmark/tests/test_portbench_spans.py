"""The port's spans as the benchmark reads them: the attribution of device
time and idle time to spans pinned on synthetic profiles, a CPU
rehearsal that reads the host-clock span metrics and no device metric,
and, on a card, K1's launches told from K2's by their spans."""

import random
from typing import NamedTuple

import pytest

from benchmark.harness import spans as hs
from benchmark.harness import timeline
from benchmark.tests.conftest import rehearse


class S(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int


def test_attribute_by_hand():
    sp = [S("job", 0, 100, -1), S("pcg", 10, 60, 0),
          S("kernel.ba_schur_matvec", 20, 25, 1), S("linearize", 70, 90, 0)]
    ev = [("cudaLaunchKernel", False, 21, 24, 1),
          ("block_sum_kernel", True, 30, 40, 1),
          ("cudaLaunchKernel", False, 12, 13, 2),
          ("elementwise", True, 14, 18, 2),
          ("cudaLaunchKernel", False, 95, 96, 3),
          ("copy", True, 96, 99, 3),
          ("orphan", True, 50, 55, 9),
          ("cudaStreamSynchronize", False, 41, 58, 4)]
    a = hs.attribute(ev, sp, 0, 110)
    assert a.busy_ns == 22 and a.idle_ns == 88
    assert a.device_ns == [3, 4, 10, 0] and a.unattributed_ns == 5
    assert a.idle_span_ns == [14, 10, 12, 41] and a.outside_ns == 11
    assert a.launches == [1, 1, 1, 0] and a.syncs == [0, 1, 0, 0]
    assert a.op_span == [2, 1, 0, -1]
    assert hs.within(sp, "pcg") == [False, True, True, False]
    rows = {r[0]: r for r in hs.table(sp, a)}
    assert rows["linearize"][3] == 41e-9 and rows["(no span)"][2] == 5e-9


def _nested(rng, lo, hi, parent, out, depth):
    """Random spans nested inside [lo, hi] as a call stack nests them."""
    t = lo
    while depth < 4 and hi - t > 4 and rng.random() < 0.8:
        s = rng.randint(t, hi - 2)
        e = rng.randint(s + 1, hi)
        out.append(S(f"s{depth}", s, e, parent))
        _nested(rng, s, e, len(out) - 1, out, depth + 1)
        t = e + 1


def _brute_innermost(sp, t):
    held = [i for i, s in enumerate(sp) if s.start_ns <= t <= s.end_ns]
    return max(held, key=lambda i: (sp[i].start_ns, -sp[i].end_ns, i),
               default=-1)


@pytest.mark.parametrize("seed", range(6))
def test_attribute_adds_up(seed):
    """Device time over spans plus unattributed time is the busy time
    (overlapping ops counted once); idle time over spans plus idle time
    outside every span is the idle time; each op and gap goes to the
    innermost span as a brute-force search finds it."""
    rng = random.Random(seed)
    sp = [S("job", 0, 1000, -1)]
    _nested(rng, 0, 1000, 0, sp, 1)
    ev = []
    for c in range(1, 60):
        t = rng.randint(-50, 1050)
        ev.append(("cudaLaunchKernel", False, t, t + 2, c))
        s = t + rng.randint(0, 40)
        ev.append(("k", True, s, s + rng.randint(1, 60),
                   c if rng.random() < 0.9 else 0))
    lo, hi = -10, 1100
    a = hs.attribute(ev, sp, lo, hi)
    dev = [(s, e) for _, d, s, e, _ in ev if d]
    busy = timeline.union_s(dev, lo, hi)
    assert a.busy_ns == busy and a.idle_ns == hi - lo - busy
    assert sum(a.device_ns) + a.unattributed_ns == busy
    assert sum(a.idle_span_ns) + a.outside_ns == a.idle_ns
    launch = {c: s for _, d, s, _, c in ev if not d}
    want = [_brute_innermost(sp, launch[c]) if c in launch else -1
            for _, d, _, _, c in ev if d]
    assert a.op_span == want
    idle = [0] * len(sp)
    for s, e in timeline.gaps(dev, lo, hi):
        i = _brute_innermost(sp, (s + e) / 2)
        if i >= 0:
            idle[i] += e - s
    assert a.idle_span_ns == idle
    assert sum(a.launches) == sum(lo <= launch[c] <= hi
                                  and _brute_innermost(sp, launch[c]) >= 0
                                  for c in launch)


def test_cpu_rehearsal_reads_the_span_metrics(tiny_copy):
    result, code = rehearse(tiny_copy, "tiny.adjust", trace=1)
    assert code == 0 and result["correct"], result["checks"]
    m = result["metrics"]
    assert m["cg_iter_ms"]["value"] > 0
    assert 0 < m["linearize_s"]["value"]
    assert 0 < m["job_setup_s"]["value"]
    for name in ("launches_per_cg", "pcg_idle", "device_idle.adjust",
                 "k1_roofline"):
        assert name not in m


@pytest.mark.cuda
def test_k1_block_sums_go_to_k1(cuda_device, tiny_copy):
    """Each K1 span holds its launch call, and the kernels K1 and K2 both
    name (`block_sum_kernel`, `finish_kernel`) go to the span of the
    entry point that launched them; K1's to ``kernel.ba_schur_matvec``."""
    import time

    from benchmark.harness import cell as cells
    from benchmark.harness import runner

    cell = cells.load(tiny_copy, "tiny.adjust",
                      root=tiny_copy.parent / "benchmark")
    run = runner.Run(cell, 5, 0.01, 1, cuda_device, time.perf_counter())
    run.job = cell.job.Job(run)
    run.job.setup()
    sp = hs.traced_profile(run)
    k1 = [i for i, s in enumerate(sp.spans)
          if s.name == "kernel.ba_schur_matvec"]
    assert k1 and all(sp.attribution.launches[i] >= 1 for i in k1)
    owner = {}
    for name, i in zip(sp.op_names, sp.attribution.op_span):
        if any(k in name for k in hs.SHARED_KERNELS):
            key = sp.spans[i].name if i >= 0 else None
            owner[key] = owner.get(key, 0) + 1
    assert set(owner) == {"kernel.ba_schur_matvec",
                          "kernel.ba_prepare_reduction"}, owner
    assert owner["kernel.ba_schur_matvec"] >= len(k1)
