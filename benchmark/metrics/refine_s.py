"""refine_s: mean seconds per adjustment in the refinement
(`refine.Refiner` and `refine.converge`; the call ends in host reads)."""


def read(run):
    t = [r["refine_s"] for r in run.completed()]
    return sum(t) / len(t) if t else None
