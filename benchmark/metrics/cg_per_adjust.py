"""cg_per_adjust: mean PCG iterations per adjustment, the program's own
counts: `RCSResult.history[*]["cg_it"]` of the solve and
`Convergence.cg_iterations` of the refinement."""


def read(run):
    n = [r["cg"] for r in run.completed()]
    return sum(n) / len(n) if n else None
