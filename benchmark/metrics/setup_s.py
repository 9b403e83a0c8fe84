"""setup_s: seconds from the process's start to the window's start: the
imports, the inputs made from the seed, the kernels' build (only the
first run of a checkout builds), the upload and the warm-up job."""


def read(run):
    return run.setup_s
