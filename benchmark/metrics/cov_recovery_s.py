"""cov_recovery_s.<config>: seconds of the point blocks' recovery
(`cov_direct.point_covariance_dense`) in `cov_all`'s calls run one by one
between CUDA events (`jobs.covariance.Job.stages`)."""


def read(run):
    return run.cached("cov_stages", run.job.stages)["recovery"]
