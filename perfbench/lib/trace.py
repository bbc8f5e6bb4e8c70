"""Reading a ``torch.profiler`` trace: kernel kinds, device time by the
program's ranges, the device's busy time and the host's idle gaps.

``KINDS`` and :func:`range_device_ms` are frozen copies of the port's
``profile_training.py`` (kernel-name patterns, first match wins; device
time of each range without the ranges nested in it, layers merged as
``layer*``).  The program's ranges are those whose names start with the
model family's ``RANGE_PREFIX``.  Device-side events are the kernels,
copies and sets the profiler records on the card; the ranges' own
device-side rows (the program's and the benchmark's ``perfbench/...``)
span kernels and are left out.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from torch.autograd import DeviceType

from perfbench.lib import spec

OWN_RANGE = "perfbench/"  # the benchmark's spans
WINDOW = OWN_RANGE + "traced"  # the span around the whole traced work
TOP = 10

KINDS = [
    ("fused CE (K1-K3)", r"fused_ce"),
    ("flash attention forward (K5 fwd)", r"flash_attn_fwd"),
    ("flash attention backward (K5 dkv, dq)", r"flash_attn_bwd"),
    ("scan (routing cumsum)", r"scan"),
    ("matmul (cuBLAS)", r"gemm|nvjet|xmma|cutlass|sm90_"),
    ("reduce", r"reduce|Reduce|norm"),
    ("copy / cast", r"copy|Copy|Memcpy|Memset|cast"),
    ("index / scatter / gather", r"index|scatter|gather|Index|Scatter|Gather"),
    ("elementwise", r"elementwise|Elementwise|vectorized|unrolled"),
]


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name):
            return kind
    return "other"


def _is_range(name: str, prefix: str) -> bool:
    return name.startswith(prefix) or name.startswith(OWN_RANGE)


def range_device_ms(events, per: int, prefix: str | None = None
                    ) -> dict[str, dict[str, float]]:
    """{range name: {kind of kernel: device ms per step}} of the ranges
    whose names start with ``prefix`` (by default any model family's
    ``RANGE_PREFIX``), each without the ranges nested in it, the prefix
    dropped and layer ranges merged over layers ("layer*/attention")."""
    prefixes = spec.range_prefixes() if prefix is None else (prefix,)
    out: dict[str, dict[str, float]] = {}
    for evt in events:
        if evt.device_type != DeviceType.CPU or not evt.name.startswith(prefixes):
            continue
        start = next(p for p in prefixes if evt.name.startswith(p))
        name = re.sub(r"layer\d+", "layer*", evt.name[len(start):])
        slot = out.setdefault(name, {})
        stack = [evt]
        while stack:  # the range's ops, down to the next nested range
            e = stack.pop()
            for k in e.kernels:
                kind = kind_of(k.name)
                slot[kind] = slot.get(kind, 0.0) + k.duration / 1e3 / per
            stack.extend(c for c in e.cpu_children
                         if not c.name.startswith(prefixes))
    return out


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


@dataclass
class Trace:
    """What the metrics read from one traced window of ``per`` steps or
    calls."""

    per: int
    window_s: float
    busy_s: float
    kernels: list  # (name, start us, end us) of every device operation
    ranges: dict  # range_device_ms of the program's ranges
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def kernel_s(self, pattern: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose names match."""
        rx = re.compile(pattern)
        hits = [(b - a) for n, a, b in self.kernels if rx.search(n)]
        return sum(hits) / 1e6, len(hits)


def _host_label(stack, prefix: str) -> str:
    """The innermost range (the program's or the benchmark's) and op on
    the host's stack; "-" where there is none (the host ran Python)."""
    ranges = [e.name for e in stack if _is_range(e.name, prefix)]
    ops = [e.name for e in stack if not _is_range(e.name, prefix)]
    where = re.sub(r"layer\d+", "layer*", ranges[-1]) if ranges else "-"
    return f"{where} | {ops[-1] if ops else '-'}"


def _idle_gaps(kernels, cpu, lo, hi, prefix: str) -> list:
    """[label, seconds] of the device's idle time in [lo, hi], by what the
    host's innermost range and op were at the start of each gap."""
    gaps, end = [], lo
    for _, a, b in sorted(kernels, key=lambda k: k[1]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    points = sorted((g0, i) for i, (g0, _) in enumerate(gaps))
    evs = sorted(cpu, key=lambda e: e.time_range.start)
    active: dict[int, object] = {}
    by: dict[str, float] = {}
    j = 0
    for t, i in points:
        while j < len(evs) and evs[j].time_range.start <= t:
            active[id(evs[j])] = evs[j]
            j += 1
        for key in [k for k, e in active.items() if e.time_range.end <= t]:
            del active[key]
        stack = sorted(active.values(), key=lambda e: e.time_range.start)
        label = _host_label(stack, prefix)
        by[label] = by.get(label, 0.0) + (gaps[i][1] - gaps[i][0]) / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:TOP]


def summarize(prof, per: int, prefix: str) -> Trace:
    """The :class:`Trace` of a profile whose work ran inside one
    ``perfbench/traced`` span; ``prefix`` starts the program's ranges."""
    events = prof.events()
    window = [e for e in events
              if e.device_type == DeviceType.CPU and e.name == WINDOW]
    if len(window) != 1:
        raise RuntimeError(f"expected one {WINDOW} span, found {len(window)}")
    lo, hi = window[0].time_range.start, window[0].time_range.end
    thread = window[0].thread
    kernels = []
    for e in events:
        if e.device_type != DeviceType.CPU and not _is_range(e.name, prefix):
            a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if b > a:
                kernels.append((e.name, a, b))
    cpu = [e for e in events if e.device_type == DeviceType.CPU
           and e.thread == thread and e.time_range.end > e.time_range.start
           and e.name != WINDOW]
    by_name: dict[str, float] = {}
    for n, a, b in kernels:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    ops = sorted(([n, s] for n, s in by_name.items()), key=lambda kv: -kv[1])
    return Trace(
        per=per, window_s=(hi - lo) / 1e6,
        busy_s=_union_us((a, b) for _, a, b in kernels) / 1e6,
        kernels=kernels,
        ranges=range_device_ms(events, per, prefix),
        device_ops=ops[:TOP],
        idle_gaps=_idle_gaps(kernels, cpu, lo, hi, prefix),
    )
