"""k1_roofline: K1's (the Schur matvec, `csrc/schur_matvec.cu`) share of
its roofline, %: the least time for its bytes and flops at the cell's
packed rows (`harness.work.k1_work`, `bound_ms`) over its time per call in
chains between CUDA events."""


def read(run):
    if not run.on_card:
        return None
    from benchmark.harness import layers, timeline, work
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    fv, spec, state = layers.view_major(run)
    b, rc, rg, _ = engine.prepare(fv, state, spec, 1e-6, couple_global=True)
    pp = kernels.pack_fm(b, fv, lean_only=True)
    ec, eg = b.extra_c.contiguous(), b.extra_g.contiguous()
    rc, rg = rc.contiguous(), rg.contiguous()
    ms = timeline.per_call_ms(
        lambda: kernels.schur_matvec_rows(pp, ec, eg, rc, rg))
    N = fv.num_points * fv.views
    bound, _ = work.bound_ms(work.k1_work(N, fv.num_points, fv.num_images,
                                          pp.g, fv.views))
    return 100.0 * bound / ms
