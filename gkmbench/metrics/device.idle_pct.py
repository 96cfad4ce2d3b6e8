"""device.idle_pct: the share of the traced window in which nothing runs
on the device (the union of kernel, copy and set intervals)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
