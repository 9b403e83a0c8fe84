"""launches_per_cg: kernel-launch CUDA runtime calls made inside the
port's ``pcg`` spans per PCG iteration, in the job profiled by
`harness.spans.traced_profile`."""


def read(run):
    if not run.on_card:
        return None
    from benchmark.harness import spans

    sp = spans.traced_profile(run)
    if sp is None:
        return None
    pcg = [s for s in sp.spans if s.name == "pcg"]
    it = sum(s.counts.get("iterations", 0) for s in pcg)
    inside = spans.within(sp.spans, "pcg")
    return spans.total(sp.attribution.launches, inside) / it if it else None
