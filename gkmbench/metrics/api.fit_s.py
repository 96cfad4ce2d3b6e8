"""api.fit_s: the span of FastSK.fit (Gram, main solve, Platt folds),
ended by a synchronize, mean a job (traced run)."""


def read(run):
    if run.trace is None:
        return None
    per = run.trace.per_job("fit", lambda a, b: b - a)
    return sum(per) / len(per) if per else None
