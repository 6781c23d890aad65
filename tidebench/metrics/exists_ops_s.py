"""Answers returned by the window's ``multi_exists`` calls over the summed
wall time of those calls."""
from tidebench.measures import ratio


def read(run, cell):
    return ratio(run["exists"], run["exists_s"]) if run["exists"] else None
