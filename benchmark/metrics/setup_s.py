"""Seconds from the process's start to the window's: imports, the CUDA
context, loading (on a checkout's first run, building) the kernels, the
inputs from the seed, every client's warm jobs (host clock)."""


def read(run):
    return run.setup_s
