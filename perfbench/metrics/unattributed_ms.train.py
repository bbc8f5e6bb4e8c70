"""Device ms a step in no program range other than ``dmoe/backward``
itself: the traced steps' device time a step, less the device time of
every program range but ``dmoe/backward``, floored at 0.  What the
program's ranges fail to explain; read only where the backward has ranges
by block (``dmoe/.../backward``), since without them the whole backward
is unexplained."""


def read(run: dict):
    trace = run.get("trace")
    if trace is None or not any(name.endswith("/backward")
                                for name in trace.ranges):
        return None
    total = sum(b - a for _, a, b in trace.kernels) / 1e3 / trace.per
    named = sum(sum(by_kind.values()) for name, by_kind in trace.ranges.items()
                if name != "backward")
    return max(total - named, 0.0)
