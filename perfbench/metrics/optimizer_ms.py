"""Device ms a step under the program's ``dmoe/optimizer`` range (the
fused Adafactor's update)."""


def read(run: dict):
    trace = run.get("trace")
    if trace is None or "optimizer" not in trace.ranges:
        return None
    return sum(trace.ranges["optimizer"].values()) or None
