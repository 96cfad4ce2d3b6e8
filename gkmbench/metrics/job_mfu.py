"""job_mfu: the exact count matrix's int8 operations (gkmbench/yardstick.py)
over the traced window's time a job at the int8 peak, 1,979 TOP/s: the
whole job's share of the peak for the work it must do. Exact jobs only."""

from gkmbench.yardstick import INT8_OPS_PER_S


def read(run):
    t = run.trace
    if t is None or run.approx or run.jobs == 0:
        return None
    ops, _ = run.count_work()
    return 100.0 * ops / (t.window_s / run.jobs * INT8_OPS_PER_S)
