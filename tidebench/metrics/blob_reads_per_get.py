"""Whole index-blob reads (``Metrics.batched_blob_reads``) made by the
window's ``multi_get`` calls, per value asked for."""
from tidebench.measures import ratio


def read(run, cell):
    return ratio(run["get_blob_reads"], run["gets"])
