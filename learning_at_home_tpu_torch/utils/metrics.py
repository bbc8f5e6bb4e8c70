"""Unified, ALWAYS-ON metrics registry with Prometheus + JSON export.

The observability contract (ISSUE 4) splits telemetry into two layers:

- this registry: ~free headline counters/gauges a production peer exports
  by default — a server must never be blind just because ``LAH_PROFILE``
  is off.  Hot paths either increment plain instruments (a dict add under
  a lock, per *batch*/*dispatch*, never per row) or — cheaper still —
  keep their existing plain-int attributes and expose them through a
  **collector** callback evaluated only at scrape time (zero hot-path
  delta, the mechanism every component here uses);
- the span-granular :mod:`.profiling` Timeline: opt-in, feeds this
  registry via the default ``timeline`` collector so its counters appear
  on the same endpoint when enabled.

Surfaces:

- :meth:`MetricsRegistry.render_prometheus` — Prometheus text exposition
  (v0.0.4): ``# HELP`` / ``# TYPE`` / ``name{label="v"} value`` lines;
- :meth:`MetricsRegistry.snapshot` — the same data as a JSON/msgpack-safe
  dict (consumed by the ``stats`` RPC, ``bench.py`` and ``lah_top``);
- :class:`MetricsHTTPServer` — a deliberately tiny asyncio HTTP/1.1
  endpoint serving ``/metrics`` (Prometheus), ``/metrics.json``,
  ``/trace`` (Chrome trace_event JSON of this process's Timeline) and
  ``/healthz``.  One per server AND per trainer; discovery is via the
  ``telemetry.<prefix>`` DHT key family (utils/telemetry.py).

Label sets are BOUNDED: a metric accepts at most ``max_label_sets``
distinct label combinations; excess observations fold into one
``overflow="true"`` series and are counted in
``lah_metrics_dropped_label_sets_total`` — data-dependent labels (uids,
buckets) must not leak memory on a long-lived peer, the same contract as
the Timeline's counter-key cap.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional, Sequence

from learning_at_home_tpu_torch.utils import flight, sanitizer
from learning_at_home_tpu_torch.utils.profiling import timeline
from learning_at_home_tpu_torch.utils.sketch import QuantileSketch

logger = logging.getLogger(__name__)

# Histograms also feed a mergeable quantile sketch per label set (ISSUE
# 19) so lah_top can compute TRUE fleet percentiles instead of the MAX
# fallback.  The toggle exists for bench.py's observability-parity A/B
# only — production never turns it off.
_SKETCH_BACKING = True


def set_sketch_backing(on: bool) -> None:
    global _SKETCH_BACKING
    _SKETCH_BACKING = bool(on)

_INVALID_NAME_CHARS = re.compile(r"[^a-zA-Z0-9_:]")

# histogram bucket upper bounds (seconds-flavored defaults; callers pass
# their own for byte- or count-valued histograms)
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_OVERFLOW_KEY = (("overflow", "true"),)


def sanitize_metric_name(name: str) -> str:
    """Prometheus-legal metric name (invalid chars → ``_``)."""
    name = _INVALID_NAME_CHARS.sub("_", name)
    return f"_{name}" if name and name[0].isdigit() else name


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _key_str(key: tuple) -> str:
    return ",".join(f'{k}="{v}"' for k, v in key)


class _Metric:
    """Base: one named metric with a bounded map of label-set children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = sanitize_metric_name(name)
        self.help = help
        self._registry = registry
        self._lock = sanitizer.lock("metrics.instrument")
        self._values: dict[tuple, Any] = {}

    def _child_key(self, labels: dict) -> tuple:
        """Resolve (and possibly admit) the label-set key — caller holds
        ``self._lock``.  Past the cap, observations fold into the single
        overflow series so cardinality is bounded by construction."""
        if not labels:
            return ()
        key = _label_key(labels)
        if (
            key in self._values
            or len(self._values) < self._registry.max_label_sets
        ):
            return key
        self._registry._note_dropped_label_set()
        return _OVERFLOW_KEY

    def _items(self) -> list[tuple[tuple, Any]]:
        with self._lock:
            return list(self._values.items())


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        with self._lock:
            key = self._child_key(labels)
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels) if labels else (), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._child_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        with self._lock:
            key = self._child_key(labels)
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels) if labels else (), 0.0))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, registry, buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, registry)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        with self._lock:
            key = self._child_key(labels)
            state = self._values.get(key)
            if state is None:
                state = self._values[key] = {
                    "buckets": [0] * len(self.buckets), "sum": 0.0, "count": 0,
                }
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    state["buckets"][i] += 1
            state["sum"] += value
            state["count"] += 1
            if _SKETCH_BACKING:
                sk = state.get("sketch")
                if sk is None:
                    sk = state["sketch"] = QuantileSketch()
                sk.add(value)

    def _items(self) -> list[tuple[tuple, Any]]:
        # deep-copy under the lock: the live sketch/bucket state mutates
        # concurrently with scrapes, and the sketch renders to its wire
        # form here so snapshot()/render_prometheus() never touch it
        with self._lock:
            out = []
            for k, st in self._values.items():
                view: dict[str, Any] = {
                    "buckets": list(st["buckets"]),
                    "sum": st["sum"],
                    "count": st["count"],
                }
                if "sketch" in st:
                    view["sketch"] = st["sketch"].to_dict()
                out.append((k, view))
            return out


class MetricsRegistry:
    """Process-wide metric store + collector callbacks.

    Collectors are ``fn() -> dict[str, number] | None`` evaluated at
    scrape time only; a collector returning ``None`` is pruned (the
    weakref-idiom components use so a garbage-collected MoE/server stops
    exporting without an explicit unregister).  Same-named ``*_total``
    values from several collectors SUM (two servers in one process
    export one combined ``lah_server_jobs_processed_total``); all other
    names take the MAX — see :meth:`collect`.
    """

    def __init__(self, max_label_sets: int = 64):
        self.max_label_sets = max_label_sets
        self._lock = sanitizer.lock("metrics.registry")
        self._metrics: "OrderedDict[str, _Metric]" = OrderedDict()
        self._collectors: "OrderedDict[str, Callable[[], Optional[dict]]]" = (
            OrderedDict()
        )
        self._dropped_label_sets = 0

    # ---- instrument creation (get-or-create, kind-checked) ----

    def _get_or_create(self, cls, name, help, **kwargs) -> _Metric:
        name = sanitize_metric_name(name)
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls(name, help, self, **kwargs)
                self._metrics[name] = metric
            elif not isinstance(metric, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {metric.kind}"
                )
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def _note_dropped_label_set(self) -> None:
        with self._lock:
            self._dropped_label_sets += 1

    # ---- collectors ----

    def register_collector(
        self, key: str, fn: Callable[[], Optional[dict]]
    ) -> None:
        with self._lock:
            self._collectors[key] = fn

    def unregister_collector(self, key: str) -> None:
        with self._lock:
            self._collectors.pop(key, None)

    def collect(self) -> dict[str, float]:
        """Run all collectors; prune dead ones; merge same-named values.

        Merge rule: names ending in ``_total`` SUM across collectors
        (event counts from two MoE layers or two co-hosted servers add
        up), and so do names ending in ``_inflight`` / containing
        ``_inflight_`` — additive occupancy gauges like
        ``lah_client_inflight_dispatches`` (ISSUE 7: three layers each
        holding one fired-but-unjoined fan-out means THREE dispatches in
        flight, not one); everything else takes the MAX — percentiles,
        queue depths, fractions (``lah_client_overlap_fraction``) and
        other distribution-shaped gauges are NOT additive (summing two
        layers' dispatch p50s would report 2× the true latency), and
        worst-across-instances is the honest aggregate for them."""

        def additive(name: str) -> bool:
            return (
                name.endswith("_total")
                or name.endswith("_inflight")
                or "_inflight_" in name
            )
        with self._lock:
            collectors = list(self._collectors.items())
        out: dict[str, float] = {}
        dead = []
        for key, fn in collectors:
            try:
                values = fn()
            except Exception:
                logger.exception("metrics collector %r failed", key)
                continue
            if values is None:
                dead.append(key)
                continue
            for name, v in values.items():
                name = sanitize_metric_name(name)
                try:
                    v = float(v)
                except (TypeError, ValueError):
                    continue
                if name in out:
                    out[name] = (
                        out[name] + v if additive(name)
                        else max(out[name], v)
                    )
                else:
                    out[name] = v
        if dead:
            with self._lock:
                for key in dead:
                    self._collectors.pop(key, None)
        return out

    # ---- export ----

    def snapshot(self) -> dict:
        """JSON/msgpack-safe view: instruments + collected values.

        Unlabeled series render as plain numbers; labeled ones as
        ``{label-string: value}`` maps."""

        def fold(metric: _Metric, render=lambda v: v):
            items = metric._items()
            if len(items) == 1 and items[0][0] == ():
                return render(items[0][1])
            return {_key_str(k) or "": render(v) for k, v in items}

        counters, gauges, histograms = {}, {}, {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, Histogram):
                histograms[m.name] = fold(
                    m,
                    lambda st: {
                        "count": st["count"],
                        "sum": st["sum"],
                        "buckets": {
                            str(ub): n
                            for ub, n in zip(m.buckets, st["buckets"])
                        },
                        # wire-form sketch (already rendered by _items);
                        # absent on pre-sketch peers — readers treat that
                        # as the tagged MAX-fallback signal
                        **(
                            {"sketch": st["sketch"]}
                            if "sketch" in st else {}
                        ),
                    },
                )
            elif isinstance(m, Gauge):
                gauges[m.name] = fold(m)
            else:
                counters[m.name] = fold(m)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
            "collected": self.collect(),
            "dropped_label_sets": self._dropped_label_sets,
        }

    def render_prometheus(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        lines: list[str] = []

        def emit(name, kind, help, series):
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            for key, value in series:
                label_str = _key_str(key)
                label_str = f"{{{label_str}}}" if label_str else ""
                lines.append(f"{name}{label_str} {value}")

        with self._lock:
            metrics = list(self._metrics.values())
            dropped = self._dropped_label_sets
        for m in metrics:
            if isinstance(m, Histogram):
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} histogram")
                for key, st in m._items():
                    base = _key_str(key)
                    cum = 0
                    for ub, n in zip(m.buckets, st["buckets"]):
                        cum = n
                        le = "+Inf" if ub == float("inf") else repr(ub)
                        labels = f'le="{le}"' + (f",{base}" if base else "")
                        lines.append(f"{m.name}_bucket{{{labels}}} {cum}")
                    inf_labels = 'le="+Inf"' + (f",{base}" if base else "")
                    if not m.buckets or m.buckets[-1] != float("inf"):
                        lines.append(
                            f"{m.name}_bucket{{{inf_labels}}} {st['count']}"
                        )
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{m.name}_sum{suffix} {st['sum']}")
                    lines.append(f"{m.name}_count{suffix} {st['count']}")
            else:
                emit(m.name, m.kind, m.help, m._items())
        for name, value in sorted(self.collect().items()):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {value}")
        lines.append("# TYPE lah_metrics_dropped_label_sets_total counter")
        lines.append(f"lah_metrics_dropped_label_sets_total {dropped}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        """Drop every instrument and collector (test isolation only)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()
            self._dropped_label_sets = 0
        _register_timeline_collector(self)


registry = MetricsRegistry()


def _register_timeline_collector(reg: MetricsRegistry) -> None:
    """Default collector: the Timeline's (bounded) counters + span count
    surface on the same endpoint whenever profiling is enabled."""

    def collect() -> dict:
        out = {"lah_timeline_spans": float(len(timeline._spans))}
        for name, v in timeline.counters().items():
            out[f"lah_timeline_{sanitize_metric_name(name)}"] = v
        return out

    reg.register_collector("timeline", collect)
    reg.register_collector("flight", flight.recorder.metrics)


_register_timeline_collector(registry)


# --------------------------------------------------------------------------
# the per-peer HTTP endpoint
# --------------------------------------------------------------------------


class MetricsHTTPServer:
    """Tiny asyncio HTTP/1.1 endpoint for one process's telemetry.

    Routes::

        /metrics       Prometheus text (registry + collectors)
        /metrics.json  {"meta", "metrics", "spans"} — the lah_top feed
        /trace         {"traceEvents": [...]} — this process's Timeline
                       as Chrome trace_event JSON (empty when profiling
                       is off)
        /debug/flight  the flight recorder's per-component event rings
        /healthz       "ok"

    ``extra_fn`` (optional) is evaluated per ``/metrics.json`` request
    and merged into the payload — servers attach per-expert update
    counts and runtime stats, trainers their dispatch/averaging stats.
    Deliberately not a framework: request line + headers are read and
    discarded, the reply closes the connection.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        meta: Optional[dict] = None,
        extra_fn: Optional[Callable[[], dict]] = None,
    ):
        self.registry = registry if registry is not None else globals()["registry"]
        self.meta = dict(meta or {})
        self.extra_fn = extra_fn
        self._server: Optional[asyncio.base_events.Server] = None
        self.port: Optional[int] = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None

    # ---- request handling ----

    def _payload_json(self) -> dict:
        payload = {
            "meta": {**self.meta, "time": time.time()},
            "metrics": self.registry.snapshot(),
            "spans": timeline.summary(),
        }
        if self.extra_fn is not None:
            try:
                payload.update(self.extra_fn() or {})
            except Exception:
                logger.exception("metrics extra_fn failed")
        return payload

    def _route(self, path: str) -> tuple[int, str, bytes]:
        if path in ("/metrics", "/"):
            return 200, "text/plain; version=0.0.4; charset=utf-8", (
                self.registry.render_prometheus().encode()
            )
        if path == "/metrics.json":
            return 200, "application/json", json.dumps(
                self._payload_json()
            ).encode()
        if path == "/trace":
            return 200, "application/json", json.dumps(
                {"traceEvents": timeline.chrome_trace(
                    self.meta.get("role") and
                    f"lah-{self.meta['role']}" or None
                )}
            ).encode()
        if path == "/debug/flight":
            return 200, "application/json", json.dumps(
                flight.recorder.snapshot()
            ).encode()
        if path == "/healthz":
            return 200, "text/plain", b"ok"
        return 404, "text/plain", b"not found"

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=10)
            parts = request.decode("latin1", "replace").split()
            path = parts[1].split("?", 1)[0] if len(parts) >= 2 else "/"
            # drain headers (we never read a body) — BOUNDED: each
            # readline resets its own timeout, so without a line cap a
            # dribbling client (one header every 9 s, no terminator)
            # would pin this task and socket forever on every peer
            for _ in range(100):
                line = await asyncio.wait_for(reader.readline(), timeout=10)
                if line in (b"\r\n", b"\n", b""):
                    break
            else:
                return  # header flood: drop the connection, no reply
            try:
                status, ctype, body = self._route(path)
            except Exception:
                logger.exception("metrics endpoint failed for %s", path)
                status, ctype, body = 500, "text/plain", b"internal error"
            reason = {200: "OK", 404: "Not Found", 500: "Internal Server Error"}
            head = (
                f"HTTP/1.1 {status} {reason.get(status, 'OK')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: close\r\n\r\n"
            ).encode("latin1")
            writer.write(head + body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except (OSError, RuntimeError):
                # close on an already-dead transport (R6: narrowed from
                # a blanket Exception swallow)
                pass
