"""Seconds from the process's start to the window's: imports, the kernels'
load (and build, on a checkout's first run), weights, engine and
warm-up."""


def read(run):
    return run.setup_s
