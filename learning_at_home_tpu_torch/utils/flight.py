"""Always-on bounded flight recorder (ISSUE 19 layer 4).

The postmortem story for a swarm where the failing peer may already be
gone: every component appends structured events (sheds with reason,
preemptions, hedge fires, drain transitions, SLO state changes,
watchdog/sanitizer trips) into a per-component bounded ring.  Recording
is a dict append under one leaf lock — always on, like the metrics
registry, never gated on ``LAH_PROFILE``.

Surfaces:

- ``/debug/flight`` on every :class:`~.metrics.MetricsHTTPServer` — the
  live rings as JSON;
- :func:`dump` — an on-disk JSON artifact written when something is
  already wrong (SLO PAGE, dispatch-watchdog fire, sanitizer violation).
  Dumps are throttled per reason so a violation storm cannot fill the
  disk; the artifact directory is ``LAH_FLIGHT_DIR`` (defaulting to
  ``<tmp>/lah_flight``).

Clock: events carry both wall time and the module's ``_monotonic`` seam,
which ``sim/clock.py`` patches onto the virtual clock — macro-sim flight
events are ordered in *virtual* time, same contract as the scheduler.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from collections import deque
from typing import Optional

from learning_at_home_tpu_torch.utils import sanitizer

logger = logging.getLogger(__name__)

_monotonic = time.monotonic  # clock seam (sim/clock.py SEAMS)

DEFAULT_CAPACITY = 256  # events kept per component ring
MAX_COMPONENTS = 32  # bounded like metric label sets
DUMP_MIN_INTERVAL_S = 30.0  # per-reason dump throttle
_OVERFLOW_COMPONENT = "overflow"


class FlightRecorder:
    """Per-component bounded rings of structured events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._lock = sanitizer.lock("flight.recorder")
        self._rings: dict[str, deque] = {}
        self._events_total = 0
        self._dropped_components = 0
        self._dumps_total = 0
        self._last_dump: dict[str, float] = {}

    def record(self, component: str, kind: str, **fields) -> None:
        """Append one event; JSON-scalar fields only by convention."""
        evt = {
            "t_mono": _monotonic(),
            "t_wall": time.time(),
            "kind": str(kind),
            **fields,
        }
        with self._lock:
            ring = self._rings.get(component)
            if ring is None:
                if len(self._rings) >= MAX_COMPONENTS:
                    self._dropped_components += 1
                    component = _OVERFLOW_COMPONENT
                ring = self._rings.setdefault(
                    component, deque(maxlen=self.capacity)
                )
            ring.append(evt)
            self._events_total += 1

    def snapshot(self) -> dict:
        """JSON-safe view of every ring (the ``/debug/flight`` body)."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "events_total": self._events_total,
                "dumps_total": self._dumps_total,
                "dropped_components": self._dropped_components,
                "components": {
                    name: list(ring) for name, ring in self._rings.items()
                },
            }

    def metrics(self) -> dict:
        with self._lock:
            return {
                "lah_flight_events_total": float(self._events_total),
                "lah_flight_dumps_total": float(self._dumps_total),
            }

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write the rings to a JSON artifact; returns the path, or None
        when throttled or on any I/O failure (a postmortem aid must never
        become a new failure mode)."""
        now = _monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < DUMP_MIN_INTERVAL_S:
                return None
            self._last_dump[reason] = now
            seq = self._dumps_total
            self._dumps_total += 1
        payload = {
            "reason": reason,
            "written_at": time.time(),
            "pid": os.getpid(),
            **self.snapshot(),
        }
        try:
            if path is None:
                root = os.environ.get("LAH_FLIGHT_DIR") or os.path.join(
                    tempfile.gettempdir(),
                    "lah_flight",  # lah-lint: ignore[R9] artifact dir name, not a metric
                )
                os.makedirs(root, exist_ok=True)
                path = os.path.join(
                    root, f"flight_{reason}_{os.getpid()}_{seq}.json"
                )
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(payload, fh)
            logger.warning("flight recorder dumped %s (%s)", path, reason)
            return path
        except OSError as e:
            logger.warning("flight dump failed for %s: %s", reason, e)
            return None

    def clear(self) -> None:
        """Test isolation only."""
        with self._lock:
            self._rings.clear()
            self._events_total = 0
            self._dropped_components = 0
            self._dumps_total = 0
            self._last_dump.clear()


recorder = FlightRecorder()

record = recorder.record
dump = recorder.dump
