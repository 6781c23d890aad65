"""From the start of the process to the start of the window: imports, the
card, kernel builds and loads, the preload and its flush."""


def read(run, cell):
    return run["setup_s"]
