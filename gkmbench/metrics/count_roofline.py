"""count_roofline: the exact count matrix's bound (its window-pair
triangle at 2 g alpha int8 operations a pair, at 1,979 TOP/s, or its
bytes at 3.35 TB/s, whichever is larger; gkmbench/yardstick.py) over the
device busy time inside the compute_kernel span, whatever runs there.
Exact jobs only: an approx job computes no exact matrix."""


def read(run):
    t = run.trace
    if t is None or run.approx:
        return None
    busy = t.per_job("compute_kernel", t.busy_in)
    if not busy or sum(busy) <= 0:
        return None
    return 100.0 * run.count_bound_s() * len(busy) / sum(busy)
