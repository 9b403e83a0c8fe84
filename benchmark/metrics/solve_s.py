"""solve_s: mean seconds per adjustment in `parallel.solver.solve` (the
f32 LM driver; the call ends in host reads)."""


def read(run):
    t = [r["solve_s"] for r in run.completed()]
    return sum(t) / len(t) if t else None
