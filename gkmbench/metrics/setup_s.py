"""setup_s: process start to the window's start, host clock (import, the
CUDA context, the kernels' build or load, the data, one warm job)."""


def read(run):
    return run.setup_s
