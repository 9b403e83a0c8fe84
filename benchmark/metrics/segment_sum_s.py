"""segment_sum_s: device seconds of the work launched inside the port's
``rcs.point_sum`` and ``rcs.image_sum`` spans (the block-layout engine's
per-point segment sums over the point order and per-image sums over the
blocked image layout: `rcs._seg_point`, `rcs._seg_image`) in the
adjustment profiled by `harness.spans.traced_profile`.  Work replayed
inside a CUDA graph goes to the span of the graph launch (``pcg``).
None where no such span was recorded (a point-major network, or a port
without the spans)."""


def read(run):
    if not run.on_card:
        return None
    from benchmark.harness import spans

    spans.traced(run)
    sp = spans.traced_profile(run)
    if sp is None:
        return None
    inside = [a or b for a, b in zip(spans.within(sp.spans, "rcs.point_sum"),
                                     spans.within(sp.spans, "rcs.image_sum"))]
    if not any(inside):
        return None
    return spans.total(sp.attribution.device_ns, inside) / 1e9
