"""Values returned by the window's ``multi_get`` calls over the summed wall
time of those calls."""
from tidebench.measures import ratio


def read(run, cell):
    return ratio(run["gets"], run["get_s"]) if run["gets"] else None
