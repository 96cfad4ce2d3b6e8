"""engine.stage_s: the host wall of the port's spans ``engine.build``
(the engine's constructor: the length sort, packing, kernel plans) and
``engine.stage`` (sequences to the device, one-hot windows or window
codes), over the engines built, one a job, as the port counts them while
the traced window's profiler records (gkmbench/program_counters.py)."""

from gkmbench import program_counters


def read(run):
    if run.trace is None:
        return None
    return program_counters.span_wall_a_entry(
        program_counters.read(), ["engine.build", "engine.stage"], "engine.build")
