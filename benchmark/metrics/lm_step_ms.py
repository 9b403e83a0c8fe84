"""lm_step_ms: ms per LM step at fixed CG work (`engine.lm_step` with 8
CG iterations and tol 0, through the kernels, each step ending in a host
read of max|dx|, as the port's bench defines its fixed-cg8 step), on the
host clock over `STEPS` steps after two untimed ones."""

import time

STEPS = 32


def read(run):
    if not run.on_card:
        return None
    from benchmark.harness import layers
    from bundle_adjustment_tpu_torch.parallel import engine, rcs

    fv, spec, state = layers.view_major(run)

    def step(s):
        dxp, dxc, dxg, _, _ = engine.lm_step(
            fv, s, spec, 1e-6, cg_tol=0.0, cg_maxiter=8, stall_limit=9,
            use_kernels=True)
        s, mdx = rcs.apply_step(s, dxp, dxc, dxg)
        float(mdx)
        return s

    s = step(step(state))
    t0 = time.perf_counter()
    for _ in range(STEPS):
        s = step(s)
    return (time.perf_counter() - t0) / STEPS * 1e3
