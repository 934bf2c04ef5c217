"""Seconds from the process's start to the window's: imports, the graph and
its tables (built on a checkout's first run), the seed's inputs, and one
warm-up job (the build of the native engine and the kernels on a first run)."""


def read(run):
    return run.setup_s
