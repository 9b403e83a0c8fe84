"""adjust_s: the window's seconds over the adjustments it completed (one
in flight at a time, so the mean time of an adjustment, gaps included)."""


def read(run):
    done = run.completed()
    return run.window_s / len(done) if done else None
