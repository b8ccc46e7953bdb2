"""Seconds from the process's start to the window's start: imports, the
card's start-up, the kernels' build or load, the inputs, one warm job an
input (host clock)."""


def read(run):
    return run.setup_s
