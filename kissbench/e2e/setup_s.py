"""Seconds from the start of the process to the start of the window:
imports, the kernels' load (or build), the inputs, what the traffic needs
before the window (an index), one warm operation."""


def read(w):
    return w.setup_s
