"""svm.iter_us: kernel B's device time in the traced window (its entries
among the trace's largest device operations) over the window's
iterations (svm.iters times the jobs), in microseconds an iteration."""

from gkmbench import program_counters


def read(run):
    t = run.trace
    if t is None:
        return None
    iters = program_counters.iterations_a_job(run)
    b_s = sum(s for name, s in t.device_ops if program_counters.B_KERNEL in name)
    if iters is None or b_s <= 0:
        return None
    return 1e6 * b_s / (iters * run.jobs)
