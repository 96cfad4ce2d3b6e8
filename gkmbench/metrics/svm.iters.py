"""svm.iters: kernel B's serial SMO iterations a job, the main solve's
and the longest Platt fold's (each launch's longest problem sets its
time): the port's counter ``smo.iterations`` over the process's jobs
(traced run; gkmbench/program_counters.py)."""

from gkmbench import program_counters


def read(run):
    if run.trace is None:
        return None
    return program_counters.iterations_a_job(run)
