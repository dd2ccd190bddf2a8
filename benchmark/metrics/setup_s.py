"""Seconds from the process's start to the first timed unit: imports, the
CUDA context, weights, kernels loaded (built in a checkout's first run)
and one warm unit of the cell's shapes (host clock)."""


def read(run):
    return run.setup_s
