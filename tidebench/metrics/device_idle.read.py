"""Share of the traced window in which no operation ran on the device, in %."""


def read(run, cell):
    trace = run.get("trace")
    if trace is None or not run.get("device_window_s"):
        return None
    return 100.0 * (1.0 - trace.busy_s() / run["device_window_s"])
