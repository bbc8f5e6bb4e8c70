"""The share of the traced steps' wall time in which no operation ran on
the device: 1 - the union of device operations' intervals / the window."""


def read(run: dict):
    trace = run.get("trace")
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
