"""Device ms a step under the program's ``dmoe/layer*/moe/backward``
ranges: the MoE blocks' gradient (the router, the gathers' backward, the
experts' gradient products) and their residual add, without their remat
recompute (which falls in ``dmoe/layer*/moe``)."""


def read(run: dict):
    trace = run.get("trace")
    if trace is None or "layer*/moe/backward" not in trace.ranges:
        return None
    return sum(trace.ranges["layer*/moe/backward"].values()) or None
