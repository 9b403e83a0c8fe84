"""pcg_masked_share: masked PCG iterations (run by a CUDA-graph replay
after the loop had stopped, changing nothing) as a % of the iterations
that counted: the ``masked`` counts of the port's ``pcg`` spans over
their ``iterations``, summed over the `harness.spans.traced` jobs.  None
off the card, and where the spans carry no ``masked`` count (a port
without the graph route)."""


def read(run):
    if not run.on_card:
        return None
    from benchmark.harness import spans

    jobs = spans.traced(run)
    pcg = [s for j in jobs or () for s in j if s.name == "pcg"]
    if not any("masked" in s.counts for s in pcg):
        return None
    it = sum(s.counts.get("iterations", 0) for s in pcg)
    masked = sum(s.counts.get("masked", 0) for s in pcg)
    return 100.0 * masked / it if it else None
