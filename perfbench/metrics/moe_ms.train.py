"""Device ms a step under the program's ``dmoe/layer*/moe`` ranges: the
MoE layers' forward and their remat recompute (their backward falls in
``dmoe/backward``)."""


def read(run: dict):
    trace = run.get("trace")
    if trace is None or "layer*/moe" not in trace.ranges:
        return None
    return sum(trace.ranges["layer*/moe"].values()) or None
