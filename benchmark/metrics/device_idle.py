"""device_idle.<job>[.<config>]: % of one whole profiled job's host span
(an adjustment, a full covariance) in which no kernel, copy or set ran on
the device (`harness.timeline`)."""


def read(run):
    if not run.on_card:
        return None
    p = run.profile()
    return 100.0 * (1.0 - p.busy_s / p.window_s)
