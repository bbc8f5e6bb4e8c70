"""Device ms a step under the program's ``dmoe/loss/backward`` range: the
loss's gradient (the fused CE's K2 and K3, the head's gradient)."""


def read(run: dict):
    trace = run.get("trace")
    if trace is None or "loss/backward" not in trace.ranges:
        return None
    return sum(trace.ranges["loss/backward"].values()) or None
