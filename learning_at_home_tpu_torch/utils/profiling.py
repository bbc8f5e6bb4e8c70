"""Tracing / profiling: per-RPC timing spans and event counters.

The reference has nothing beyond logging and its benchmark scripts
(SURVEY.md §5.1).  The port's copy of the JAX package's module keeps
its per-RPC timing spans (device traces: ``torch.profiler``, as
``profile_training.py`` takes them):

- a process-wide :class:`Timeline` of timing spans (bounded ring buffer,
  thread-safe, ~100ns overhead when disabled) used by the RPC client, the
  task pools, and the MoE dispatcher;
- named **event counters** on the same Timeline (:meth:`Timeline.count`)
  for hot-path pipeline telemetry — overlapped dispatches, staging-buffer
  reuse, per-bucket cache hits — where a duration span is the wrong shape.

Enable collection with ``LAH_PROFILE=1`` in the environment or
``timeline.enable()``; read results with ``timeline.summary()`` /
``timeline.counters()``.

**Distributed tracing** (ISSUE 4): spans may carry a compact *trace id*
(:func:`new_trace_id`, 16 hex chars) allocated once per logical operation
— the MoE dispatcher mints one per forward dispatch, carries it in RPC
meta (``{"trace": ...}``, docs/PROTOCOL.md), and the server stamps it
onto its handler/pool/runtime spans — so one forward+backward yields a
JOINABLE end-to-end trace across processes.  Export with
:meth:`Timeline.chrome_trace` (Chrome ``trace_event`` JSON for
chrome://tracing): span start times are rebased from ``time.monotonic``
to the wall clock at export, so traces merged from multiple processes on
one machine align.  Trace ids are only allocated while the timeline is
enabled — disabled-path requests carry no extra meta and record nothing.

The server Runtime emits one span per pipeline stage per batch —
``runtime.stack.<pool>`` (staging-buffer copy), ``runtime.dispatch.<pool>``
(jitted call dispatch), ``runtime.materialize.<pool>`` (device wait) — plus
an umbrella ``runtime.<pool>`` span covering dispatch→materialized, so a
summary shows exactly where hot-path time goes.

The CLIENT dispatch pipeline (PR 2) mirrors this: per-dispatch
``client.pack.forward`` / ``client.pack.backward`` spans (host-thread
serialization — off the event loop by construction), counters
``client.pack.bytes`` and ``client.pack_once.bytes_saved`` (duplicated
wire-encode bytes the pack-once fan-out avoided), and per-RPC
``rpc.<msg_type>`` spans covering the on-loop exchange.  The
serialize-vs-wait breakdown also surfaces without profiling enabled via
``RemoteMixtureOfExperts.pack_times`` / ``wait_times`` and
``dispatch_stats()``.

The FUTURE-BASED dispatch core (ISSUE 7) splits each dispatch into two
first-class spans: ``client.dispatch.fire`` (selection + payload prep +
non-blocking fan-out submit, on the host thread) and
``client.dispatch.join`` (the time the caller actually BLOCKED waiting
for replies — emitted from the join's finally, so a timed-out join
still records).  The gap between a dispatch's fire span and its join
span is trunk compute overlapped with the in-flight RPCs; the
time-weighted aggregate surfaces always-on as
``lah_client_overlap_fraction`` (utils/metrics.py, ``dispatch_stats()``)
— the overlapped swarm step's headline observable.

The trainer-side AVERAGING subsystem (ISSUE 3) records per-round
``averaging.round`` spans and the counters ``averaging.rounds``,
``averaging.degraded_rounds``, ``averaging.bytes_sent``; like the client
dispatch path, its headline numbers (round p50/p99, group sizes,
degraded fraction) also surface without profiling via
``DecentralizedAverager.stats()`` / ``AveragingSession.averaging_stats()``.

The model step's **backward ranges** (:class:`BackwardRanges`): under
an active ``torch.profiler`` the DMoE-Transformer marks the input and the
output of each block of its forward (the embedding, each layer's
attention and MoE, the loss) with identity autograd nodes.  The output's
node opens the profiler range ``<block>/backward`` when the backward
reaches it, and the input's node closes it; autograd runs a graph's nodes
in reverse creation order, so the block's gradient (remat's recompute
included) falls inside, on whatever thread runs the backward.  Without a
profiler the model applies no marker, and its graph is the unmarked one.

Headline counters do NOT live here: the always-on cheap metrics a
production peer exports by default belong to the registry in
``utils/metrics.py`` (which also re-exports this timeline's counters as
a collector).  The Timeline is the opt-in, span-granular layer.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import threading
import time
from collections import defaultdict, deque
from typing import Iterator, Optional

import numpy as np
import torch
from torch.autograd.profiler import record_function

from learning_at_home_tpu_torch.utils import sanitizer

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{16}$")


def new_trace_id() -> str:
    """A compact (16 hex chars, 64-bit) globally-unlikely-to-collide trace
    id — small enough to ride in every RPC's msgpack meta."""
    return os.urandom(8).hex()


def valid_trace_id(value: object) -> bool:
    """Structural check for the 16-hex trace-id contract: handlers echo
    ids that pass, and silently drop anything else (a peer-supplied meta
    string must never flow into spans/replies unvalidated)."""
    return isinstance(value, str) and bool(_TRACE_ID_RE.match(value))


class Timeline:
    """Bounded, thread-safe collection of (name, start, duration) spans.

    Spans optionally carry a trace id (distributed tracing) and always
    record the emitting thread id — both consumed by the Chrome
    ``trace_event`` exporter; the summary/counter surfaces ignore them.

    Distinct COUNTER keys are capped (``max_counter_keys``): per-bucket /
    per-pool counter names are data-dependent, and a long-lived server
    with many shape buckets must not grow the dict without bound.  Counts
    for keys beyond the cap fold into one ``timeline.overflow`` bucket
    and each folded call increments ``timeline.dropped_keys``.
    """

    # counter names that must survive even at the cap (they ARE the
    # overflow accounting)
    _RESERVED_KEYS = ("timeline.overflow", "timeline.dropped_keys")

    def __init__(self, maxlen: int = 100_000, max_counter_keys: int = 512):
        # (name, start_monotonic, duration_s, trace_id|None, thread_id)
        self._spans: deque[tuple[str, float, float, Optional[str], int]] = (
            deque(maxlen=maxlen)
        )
        self._counters: defaultdict[str, float] = defaultdict(float)
        self.max_counter_keys = int(
            os.environ.get("LAH_TIMELINE_MAX_KEYS", max_counter_keys)
        )
        self._lock = sanitizer.lock("profiling.timeline")
        self.enabled = os.environ.get("LAH_PROFILE", "") not in ("", "0")
        # rebase for cross-process merges: monotonic + offset ≈ wall clock
        self._clock_offset = time.time() - time.monotonic()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()

    def record(
        self, name: str, start: float, duration: float,
        trace: Optional[str] = None,
    ) -> None:
        if self.enabled:
            entry = (name, start, duration, trace, threading.get_ident())
            with self._lock:
                self._spans.append(entry)

    def count(self, name: str, value: float = 1.0) -> None:
        """Accumulate a named event counter (no duration semantics).

        New keys beyond ``max_counter_keys`` fold into
        ``timeline.overflow`` (+``timeline.dropped_keys`` per folded
        call) instead of growing the dict — see class docstring."""
        if self.enabled:
            with self._lock:
                if (
                    name not in self._counters
                    and len(self._counters) >= self.max_counter_keys
                    and name not in self._RESERVED_KEYS
                ):
                    self._counters["timeline.overflow"] += value
                    self._counters["timeline.dropped_keys"] += 1
                    return
                self._counters[name] += value

    def counters(self, prefix: str = "") -> dict[str, float]:
        with self._lock:
            return {
                name: v
                for name, v in self._counters.items()
                if name.startswith(prefix)
            }

    @contextlib.contextmanager
    def span(self, name: str, trace: Optional[str] = None) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.record(name, t0, time.monotonic() - t0, trace=trace)

    def spans(
        self, prefix: str = ""
    ) -> list[tuple[str, float, float, Optional[str], int]]:
        with self._lock:
            return [s for s in self._spans if s[0].startswith(prefix)]

    def summary(self) -> dict[str, dict]:
        """Per-span-name count / total / p50 / p99 (milliseconds)."""
        groups: dict[str, list[float]] = defaultdict(list)
        with self._lock:
            for name, _, duration, _, _ in self._spans:
                groups[name].append(duration * 1000)
        out = {}
        for name, durs in groups.items():
            arr = np.asarray(durs)
            out[name] = {
                "count": len(arr),
                "total_ms": round(float(arr.sum()), 2),
                "p50_ms": round(float(np.percentile(arr, 50)), 3),
                "p99_ms": round(float(np.percentile(arr, 99)), 3),
            }
        return out

    # ---- Chrome trace_event export (chrome://tracing / Perfetto) ----

    def chrome_trace(self, process_name: Optional[str] = None) -> list[dict]:
        """The recorded spans as Chrome ``trace_event`` complete ("X")
        events.  ``ts`` is wall-clock microseconds (monotonic start +
        the offset captured at construction), so event lists exported by
        several processes on one machine merge into one aligned trace;
        spans that carried a trace id get ``args: {"trace": id}``.
        ``pid`` is the real OS pid and ``tid`` the recording thread —
        chrome://tracing nests same-tid events by time containment."""
        pid = os.getpid()
        events: list[dict] = [
            {
                "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": process_name or f"lah-{pid}"},
            }
        ]
        for name, start, duration, trace, tid in self.spans():
            ev = {
                "ph": "X",
                "name": name,
                "cat": name.split(".", 1)[0],
                "pid": pid,
                "tid": tid,
                "ts": (start + self._clock_offset) * 1e6,
                "dur": duration * 1e6,
            }
            if trace is not None:
                ev["args"] = {"trace": trace}
            events.append(ev)
        return events

    def save_chrome_trace(
        self, path: str, extra_events: Iterator[dict] | list = (),
        process_name: Optional[str] = None,
    ) -> int:
        """Write ``{"traceEvents": [...]}`` JSON; ``extra_events`` lets a
        caller merge event lists fetched from OTHER processes' ``/trace``
        telemetry endpoints into one file.  Returns the event count."""
        events = self.chrome_trace(process_name) + list(extra_events)
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        return len(events)


timeline = Timeline()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA activity
    where there is a card) of the enclosed block and write it as a Chrome
    trace JSON file into ``log_dir``; yields that file's path.  The
    profiler records every kernel the block launches on the card, so the
    block needs no synchronisation of its own beyond the one that ends its
    work."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace.{os.getpid()}.{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


class _OpenRange(torch.autograd.Function):
    """Identity whose backward opens ``<name>/backward``: it marks a
    block's output, whose node the backward reaches before the block's."""

    @staticmethod
    def forward(ctx, x, ranges, name):
        ctx.ranges, ctx.name = ranges, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.ranges._open(ctx.name)
        return grad, None, None


class _CloseRange(_OpenRange):
    """Identity whose backward closes ``<name>/backward``: it marks a
    block's input, whose node the backward reaches after the block's."""

    @staticmethod
    def backward(ctx, grad):
        ctx.ranges._close(ctx.name)
        return grad, None, None


class _Unmarked:
    """The marks of a forward that no profiler records: none."""

    @staticmethod
    def block_input(x: torch.Tensor, name: str) -> torch.Tensor:
        return x

    @staticmethod
    def block_output(y: torch.Tensor, name: str) -> torch.Tensor:
        return y


UNMARKED = _Unmarked()


class BackwardRanges:
    """The profiler ranges ``<name>/backward`` over the backward of marked
    blocks (module docstring), kept per thread.

    Mark a block's input with :meth:`block_input` before any of its work
    and its output with :meth:`block_output` after all of it.  The ranges
    of one set never nest: opening one closes whatever this thread still
    has open (a block whose input needed no gradient never reaches its
    closing node).  A range left open when the backward ends is closed
    then, and :meth:`close_all` closes what an aborted backward left.
    """

    def __init__(self):
        self._lock = sanitizer.lock("profiling.backward_ranges")
        self._open_by_thread: dict[int, tuple[str, record_function]] = {}

    def marks(self) -> "BackwardRanges | _Unmarked":
        """What a forward marks its blocks with: these ranges while a
        profiler records on this thread, else :data:`UNMARKED`, which
        adds no node."""
        return self if torch.autograd._profiler_enabled() else UNMARKED

    def block_input(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return _CloseRange.apply(x, self, name)

    def block_output(self, y: torch.Tensor, name: str) -> torch.Tensor:
        return _OpenRange.apply(y, self, name)

    def open_names(self) -> list[str]:
        """The names of the ranges open now, on every thread."""
        with self._lock:
            return [name for name, _ in self._open_by_thread.values()]

    def _open(self, name: str) -> None:
        tid = threading.get_ident()
        with self._lock:
            stale = self._open_by_thread.pop(tid, None)
        if stale is not None:
            stale[1].__exit__(None, None, None)
        rf = record_function(name + "/backward")
        rf.__enter__()
        with self._lock:
            self._open_by_thread[tid] = (name, rf)
        # runs when this backward ends, on the thread that ends it
        torch.autograd.Variable._execution_engine.queue_callback(
            functools.partial(self._end, tid, rf))

    def _close(self, name: str) -> None:
        tid = threading.get_ident()
        with self._lock:
            entry = self._open_by_thread.get(tid)
        if entry is not None and entry[0] == name:
            self._end(tid, entry[1])

    def _end(self, tid: int, rf: record_function) -> None:
        """Close ``rf``, the range thread ``tid`` opened, if still open."""
        with self._lock:
            entry = self._open_by_thread.get(tid)
            if entry is None or entry[1] is not rf:
                return
            del self._open_by_thread[tid]
        rf.__exit__(None, None, None)

    def close_all(self) -> None:
        """Close every range still open, on every thread."""
        with self._lock:
            left = list(self._open_by_thread.values())
            self._open_by_thread.clear()
        for _, rf in left:
            rf.__exit__(None, None, None)
