"""refine_f64_share: % of the refinement's CG iterations that ran in f64:
the ``iterations`` counts of the port's ``refine.step64`` spans (a step
redone, or run, with its inner solve in f64) over those of the ``pcg``
spans inside ``refine.step`` spans, summed over the `harness.spans.traced`
jobs.  None where the jobs hold no refinement CG (a port without the
spans)."""


def read(run):
    from benchmark.harness import spans

    jobs = spans.traced(run)
    f64 = total = 0
    for j in jobs or ():
        inside = spans.within(j, "refine.step")
        total += sum(s.counts.get("iterations", 0)
                     for s, m in zip(j, inside) if m and s.name == "pcg")
        f64 += sum(s.counts.get("iterations", 0) for s in j
                   if s.name == "refine.step64")
    return 100.0 * f64 / total if total else None
