"""pcg_graph_share: % of the PCG iterations in whole adjustments that ran
inside CUDA-graph replays: the ``graph_iterations`` counts of the port's
``pcg`` spans over their ``iterations``, summed over the
`harness.spans.traced` jobs.  None off the card, and where the spans
carry no ``graph_iterations`` count (a port without the graph route)."""


def read(run):
    if not run.on_card:
        return None
    from benchmark.harness import spans

    jobs = spans.traced(run)
    pcg = [s for j in jobs or () for s in j if s.name == "pcg"]
    if not any("graph_iterations" in s.counts for s in pcg):
        return None
    it = sum(s.counts.get("iterations", 0) for s in pcg)
    graph = sum(s.counts.get("graph_iterations", 0) for s in pcg)
    return 100.0 * graph / it if it else None
