"""linearize_s: host seconds per adjustment in the port's ``linearize``
spans (`engine.linearize`: the f32 steps and the refinement's f64
gradient), mean over the `harness.spans.traced` jobs; its device time is
in the by-span table of `harness.spans.traced_profile`."""


def read(run):
    from benchmark.harness import spans

    jobs = spans.traced(run)
    return spans.span_seconds(jobs, "linearize") if jobs else None
