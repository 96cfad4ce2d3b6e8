"""theta.ms: device busy time inside the compute_kernel span over the
position subsets the job consumed (FastSK.iterations), mean a job. Approx
jobs only: exact jobs consume no subsets."""


def read(run):
    t = run.trace
    if t is None:
        return None
    busy = t.per_job("compute_kernel", t.busy_in)
    iters = [j.iterations for j in run.window.jobs]
    if not busy or sum(busy) <= 0 or len(busy) != len(iters) or min(iters) <= 0:
        return None
    return 1000.0 * sum(b / i for b, i in zip(busy, iters)) / len(busy)
