"""camera_sum_s: device seconds of the work launched inside the port's
``compact.camera_sum`` spans (the compact multi-camera rows' global work
in linearise, the reduction and the product: `engine._camera_sum`'s
callers) in the adjustment profiled by `harness.spans.traced_profile`.
Work replayed inside a CUDA graph goes to the span of the graph launch
(``pcg``).  None where no such span was recorded (a single camera, or a
port without the span)."""


def read(run):
    if not run.on_card:
        return None
    from benchmark.harness import spans

    spans.traced(run)
    sp = spans.traced_profile(run)
    if sp is None:
        return None
    inside = spans.within(sp.spans, "compact.camera_sum")
    if not any(inside):
        return None
    return spans.total(sp.attribution.device_ns, inside) / 1e9
