"""cov_corrections_s.<config>: device seconds of the work launched inside
the port's ``cov.corrections`` span (`cov_direct.
assemble_reduced_corrections`, the pair-block corrections of S) in the
full covariance profiled by `harness.spans.traced_profile`.  Also prints
the tracing cost (`harness.spans.traced`)."""


def read(run):
    if not run.on_card:
        return None
    from benchmark.harness import spans

    spans.traced(run)
    sp = spans.traced_profile(run)
    if sp is None:
        return None
    inside = spans.within(sp.spans, "cov.corrections")
    if not any(inside):
        return None
    return spans.total(sp.attribution.device_ns, inside) / 1e9
