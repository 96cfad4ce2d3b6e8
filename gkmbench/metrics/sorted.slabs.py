"""sorted.slabs: the sorted theta engine's slab products a pass, the
port's counters ``sorted.slabs`` over ``sorted.passes`` (traced run;
gkmbench/program_counters.py). Where nothing counted a pass, as in a port
without the counters, it gives None."""

from gkmbench import program_counters


def read(run):
    if run.trace is None:
        return None
    c = program_counters.read()
    if c is None or c["sorted.passes"] == 0:
        return None
    return c["sorted.slabs"] / c["sorted.passes"]
