"""Peak device memory allocated during the window (GB of 1e9 bytes),
``max_memory_allocated`` after a reset at the window's start."""


def read(run: dict):
    peak = run.get("peak_window_bytes")
    return peak / 1e9 if peak else None
