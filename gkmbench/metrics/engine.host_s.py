"""engine.host_s: the part of the compute_kernel span in which no kernel,
copy or set runs on the device (host packing, launches, syncs), mean a
job (traced run)."""


def read(run):
    t = run.trace
    if t is None:
        return None
    per = t.per_job("compute_kernel", lambda a, b: (b - a) - t.busy_in(a, b))
    return sum(per) / len(per) if per else None
