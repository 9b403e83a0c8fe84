"""The f32 Levenberg-Marquardt phase of the scale solve (the loop
`bench.py` drives before its mixed-precision refinement).

Each step solves one damped LM system (`engine.lm_step`) and applies the
scaled step alpha * dx with alpha = min(0.25 lambda^-0.05, 0.75)
(BundleAdjustment.java:392-394; 1 at lambda = 0).  The damping starts at
``damping`` and shrinks x0.2 per step, to 0 once below 1e-9.  The phase
stops when the damping is 0 and max|dx| < 1e-3, or when the damping is 0
and max|dx| has not improved by 30% for 3 steps (the f32 floor), or after
``max_steps``.
"""

from __future__ import annotations

from typing import NamedTuple

from . import engine, rcs


class LMPhase(NamedTuple):
    steps: int
    max_dx: float          # max|alpha dx| of the last step
    cg_iterations: list    # per step


def step_scale(damping: float) -> float:
    """alpha = min(0.25 lambda^-0.05, 0.75), 1 without damping."""
    return min(0.25 * damping ** -0.05, 0.75) if damping > 0 else 1.0


def run(p, state, spec, damping=1e-2, max_steps=60, use_kernels=True,
        cg_tol=1e-4, cg_maxiter=100, stall_limit=8):
    """Run the LM phase from ``state`` on the (view-major, for the
    kernels) FMProblem ``p``.  Returns (final state, LMPhase)."""
    best, n_flat = float("inf"), 0
    its = []
    mdx = float("inf")
    k = 0
    for k in range(1, max_steps + 1):
        dxp, dxc, dxg, _, it = engine.lm_step(
            p, state, spec, damping, cg_tol=cg_tol, cg_maxiter=cg_maxiter,
            use_kernels=use_kernels, couple_global=True,
            stall_limit=stall_limit)
        alpha = step_scale(damping)
        state, mdx_t = rcs.apply_step(state, alpha * dxp, alpha * dxc,
                                      alpha * dxg)
        its.append(it)
        mdx = float(mdx_t)
        damping = 0.0 if damping < 1e-9 else damping * 0.2
        if damping == 0.0 and mdx < 1e-3:
            break
        if mdx < 0.7 * best:
            best, n_flat = mdx, 0
        else:
            n_flat += 1
            if damping == 0.0 and n_flat >= 3:
                break
    return state, LMPhase(steps=k, max_dx=mdx, cg_iterations=its)
