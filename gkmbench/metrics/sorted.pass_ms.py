"""sorted.pass_ms: device busy time inside the compute_kernel span, mean a
job, over the passes a job computed: the port's counter ``sorted.passes``
over the process's jobs, the warm one and the window's, which do the same
work (traced run; gkmbench/program_counters.py). Jobs of the sorted theta
engine only: where nothing counted a pass, as in a port without the
counter, it gives None."""

from gkmbench import program_counters


def read(run):
    t = run.trace
    if t is None or run.jobs == 0:
        return None
    c = program_counters.read()
    if c is None or c["sorted.passes"] == 0:
        return None
    busy = t.per_job("compute_kernel", t.busy_in)
    if not busy or sum(busy) <= 0:
        return None
    passes = c["sorted.passes"] / (run.jobs + 1)
    return 1000.0 * sum(busy) / len(busy) / passes
