"""job_setup_s: host seconds per adjustment that the port spends laying
the network out again for it: the ``solve.layout`` span (`solve`'s
padding, `fm_problem`, `to_view_major`) and the ``refine.build`` span
(the `Refiner`'s layouts and f64 upcast), mean over the
`harness.spans.traced` jobs."""


def read(run):
    from benchmark.harness import spans

    jobs = spans.traced(run)
    return (spans.span_seconds(jobs, "solve.layout", "refine.build")
            if jobs else None)
