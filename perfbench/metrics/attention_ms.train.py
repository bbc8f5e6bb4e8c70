"""Device ms a step under the program's ``dmoe/layer*/attention``
ranges: the attention blocks' forward and their remat recompute."""


def read(run: dict):
    trace = run.get("trace")
    if trace is None or "layer*/attention" not in trace.ranges:
        return None
    return sum(trace.ranges["layer*/attention"].values()) or None
