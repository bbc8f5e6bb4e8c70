"""Device ms a step under the program's ``dmoe/layer*/attention/backward``
ranges: the attention blocks' gradient (K5's dkv and dq at 8k), without
their remat recompute (which falls in ``dmoe/layer*/attention``)."""


def read(run: dict):
    trace = run.get("trace")
    if trace is None or "layer*/attention/backward" not in trace.ranges:
        return None
    return sum(trace.ranges["layer*/attention/backward"].values()) or None
