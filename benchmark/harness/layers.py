"""The port's layers as the per-layer readers drive them alone, after the
window: the view-major f32 problem the kernels read, built once per run
from the job's problem and a state near the optimum."""

from __future__ import annotations


def view_major(run):
    """(view-major FMProblem, spec, f32 state) of an adjust job."""
    def make():
        from bundle_adjustment_tpu_torch.parallel import engine, kernels

        problem, spec, state = run.job.program()
        fmp = engine.fm_problem(problem)
        fv = engine.to_view_major(fmp, kernels.choose_pb(
            fmp.num_points, fmp.views, fmp.free_global.shape[0]))
        return fv, spec, state

    return run.cached("view_major", make)
