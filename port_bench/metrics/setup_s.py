"""Seconds from the process's start to the window's start: CUDA, the kernel libraries,
the weights drawn and converted, the warm-up with the cell's shapes."""


def read(run):
    return run.setup_s
