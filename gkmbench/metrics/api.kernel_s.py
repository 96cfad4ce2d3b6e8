"""api.kernel_s: the span of FastSK.compute_kernel, ended by a
synchronize, mean a job (traced run)."""


def read(run):
    if run.trace is None:
        return None
    per = run.trace.per_job("compute_kernel", lambda a, b: b - a)
    return sum(per) / len(per) if per else None
