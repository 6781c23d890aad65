"""Kernel B's roofline share: the least time the window's fused Bloom probes
need (the bytes their inputs need over the memory bandwidth) over the device
time of every kernel launched inside the harness's span around the probe."""
from tidebench.roofline import span_roofline


def read(run, cell):
    return span_roofline(run, "bloom_probe")
