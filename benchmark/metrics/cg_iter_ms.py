"""cg_iter_ms: host milliseconds per PCG iteration in whole adjustments:
the time of the port's ``pcg`` spans over their ``iterations`` counts,
summed over the `harness.spans.traced` jobs."""


def read(run):
    from benchmark.harness import spans

    jobs = spans.traced(run)
    if not jobs:
        return None
    pcg = [s for j in jobs for s in j if s.name == "pcg"]
    it = sum(s.counts.get("iterations", 0) for s in pcg)
    return sum(s.end_ns - s.start_ns for s in pcg) / 1e6 / it if it else None
