"""encode.host_s: the host wall of the port's span ``encode``
(``encode_sequences``, the sequences to the engines' integer codes),
mean a job, as the port counts it while the traced window's profiler
records (gkmbench/program_counters.py)."""

from gkmbench import program_counters


def read(run):
    if run.trace is None:
        return None
    return program_counters.span_wall_a_entry(program_counters.read(), ["encode"], "encode")
