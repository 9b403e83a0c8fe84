"""pcg_idle: % of the job profiled by `harness.spans.traced_profile` in
which the device is idle while the host is inside a ``pcg`` span (an idle
gap counts where the innermost span over its middle is ``pcg`` or lies
inside one), so it is at most `device_idle.adjust`."""


def read(run):
    if not run.on_card:
        return None
    from benchmark.harness import spans

    sp = spans.traced_profile(run)
    if sp is None:
        return None
    idle = spans.total(sp.attribution.idle_span_ns,
                       spans.within(sp.spans, "pcg"))
    return 100.0 * idle / sp.window_ns
