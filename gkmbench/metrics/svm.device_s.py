"""svm.device_s: device busy time inside the fit span (the Gram, kernel
B's solves, the fold decisions), mean a job (traced run)."""


def read(run):
    t = run.trace
    if t is None:
        return None
    per = t.per_job("fit", t.busy_in)
    return sum(per) / len(per) if per and sum(per) > 0 else None
