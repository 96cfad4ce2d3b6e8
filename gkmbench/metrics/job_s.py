"""job_s: the wall of one job, host clock: the window, from the first
job's start to the last job's synchronized end, over its jobs."""


def read(run):
    return run.window.seconds / run.jobs
