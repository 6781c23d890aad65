"""The 95th percentile of the window's ``multi_exists`` call times (harness
spans on the host clock), in ms."""
from tidebench.measures import p95


def read(run, cell):
    x = p95(run["spans"].get("multi_exists", []))
    return None if x is None else x * 1e3
