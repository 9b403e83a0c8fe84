"""k2_roofline: K2's (the fused assembly, `csrc/prepare_reduction.cu`)
share of its roofline, %: the least time for its bytes and flops at the
cell's packed rows (`harness.work.k2_work`, `bound_ms`) over its time per
call in chains between CUDA events."""


def read(run):
    if not run.on_card:
        return None
    from benchmark.harness import layers, timeline, work
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    fv, spec, state = layers.view_major(run)
    b = engine.linearize(fv, state, spec, 1e-6)
    pp = kernels.pack_fm(b, fv, dtype=b.Jp[0].dtype, with_pw=True)
    ms = timeline.per_call_ms(lambda: kernels.prepare_reduction(pp))
    N = fv.num_points * fv.views
    bound, _ = work.bound_ms(work.k2_work(N, fv.num_points, fv.num_images,
                                          pp.g, fv.views))
    return 100.0 * bound / ms
