"""cov_s.<config>: the window's seconds over the full covariances it
completed (one metric per configuration, each with its own bound)."""


def read(run):
    done = run.completed()
    return run.window_s / len(done) if done else None
