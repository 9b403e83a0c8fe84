"""cov_inverse_s.<config>: seconds of the reduced system's inverse
(`cov_direct.reduced_inverse`) in `cov_all`'s calls run one by one between
CUDA events (`jobs.covariance.Job.stages`)."""


def read(run):
    return run.cached("cov_stages", run.job.stages)["inverse"]
