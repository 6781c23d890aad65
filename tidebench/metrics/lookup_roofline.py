"""Kernel C's roofline share: the least time the window's batched lookups
need over the device time of every kernel launched inside the harness's span
around the lookup."""
from tidebench.roofline import span_roofline


def read(run, cell):
    return span_roofline(run, "lookup")
