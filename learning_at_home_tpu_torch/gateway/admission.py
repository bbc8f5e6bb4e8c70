"""Admission control: shed load BEFORE quality collapses.

Three saturation signals, all cheap to read at admit time:

- **gateway occupancy** — pending streams waiting for a slot.  Slots
  full is normal (that is what continuous batching is for); an unbounded
  pending queue is not: past ``max_pending`` every accepted stream only
  inflates time-to-first-token, so the gateway sheds with a retry-after
  instead (docs/PROTOCOL.md "Gateway RPC family").
- **expert-server queue depth** — the swarm's own backpressure, read
  from the ``load.<prefix>`` DHT heartbeats the servers already publish
  (utils/telemetry.py, the same feed PR 8's routing cost model eats).
  When the WORST advertised queue exceeds ``max_server_queue``, admitting
  more decode work would pile onto servers that are already drowning.
- **KV page pressure** (paged decoder only) — a stream that cannot get
  the physical pages its prompt + budget will occupy would only churn
  the preemption path; when ``pages_needed`` exceeds the pool's free +
  reclaimable headroom (net of a one-page-per-active-slot reserve), the
  gateway sheds with a retry-after instead.  The headroom read is a
  plain-int peek at counters the ``lah-gw-decode`` thread owns — the
  same benign monitoring race as the slot mask, no lock
  (docs/CONCURRENCY.md invariant 12).

Shedding is ALWAYS a well-formed busy frame carrying ``retry_after_s``
(docs/PROTOCOL.md "Gateway RPC family"), never an error frame — page
exhaustion is backpressure, not failure.

The DHT read is a blocking control-plane round trip, so it runs on this
controller's own ``lah-gw-admission`` daemon thread on a fixed period;
``admit()`` itself only reads cached floats and the scheduler's counters
— safe to call from the front door's event loop.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

# Clock seam: sim/clock.py swaps this for a virtual clock so the inline
# refresh path (maybe_refresh) paces on simulated time.
_monotonic = time.monotonic


class AdmissionController:
    """Accept/shed decisions for one gateway."""

    def __init__(
        self,
        scheduler,
        *,
        max_pending: Optional[int] = None,
        max_server_queue: float = 64.0,
        load_fn: Optional[Callable[[], dict]] = None,
        refresh_period_s: float = 2.0,
    ):
        self.scheduler = scheduler
        if max_pending is None:
            try:
                max_pending = int(
                    os.environ.get(
                        "LAH_GW_MAX_PENDING",
                        str(4 * scheduler.decoder.max_slots),
                    )
                )
            except ValueError:
                max_pending = 4 * scheduler.decoder.max_slots
        self.max_pending = max_pending
        self.max_server_queue = float(max_server_queue)
        self._load_fn = load_fn
        self.refresh_period_s = refresh_period_s
        self._server_queue_depth = 0.0  # worst advertised depth, cached
        self._last_refresh: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.shed_total = 0
        self.shed_pages_total = 0
        self.admitted_total = 0
        self.load_refresh_failures = 0

    # ---- background server-load watch ----

    def start(self) -> "AdmissionController":
        if self._load_fn is None or self._thread is not None:
            return self

        def watch() -> None:
            while not self._stop.wait(self.refresh_period_s):
                self._refresh_once()

        self._refresh_once()
        self._thread = threading.Thread(
            target=watch, name="lah-gw-admission", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.refresh_period_s + 1)
            self._thread = None

    def maybe_refresh(self) -> bool:
        """Inline alternative to :meth:`start` for single-threaded hosts
        (the macro-sim): refresh the cached worst-queue snapshot when
        ``refresh_period_s`` has elapsed on the clock seam.  Returns
        True when a refresh actually ran."""
        if self._load_fn is None:
            return False
        now = _monotonic()
        if (
            self._last_refresh is not None
            and now - self._last_refresh < self.refresh_period_s
        ):
            return False
        self._last_refresh = now
        self._refresh_once()
        return True

    def _refresh_once(self) -> None:
        try:
            loads = self._load_fn() or {}
            depths = [
                float(rec.get("q", 0.0))
                for rec in loads.values()
                if isinstance(rec, dict)
            ]
            self._server_queue_depth = max(depths) if depths else 0.0
        except Exception as e:
            self.load_refresh_failures += 1
            logger.warning("gateway server-load refresh failed: %s: %s",
                           type(e).__name__, e)

    @property
    def server_queue_depth(self) -> float:
        return self._server_queue_depth

    # ---- the admit-time decision (event-loop safe: no I/O, no waits) ----

    def admit(
        self, pages_needed: int = 0
    ) -> tuple[bool, Optional[float], Optional[str]]:
        """(accepted, retry_after_s, reason).  retry_after_s/reason are
        None on accept.  ``pages_needed`` is the stream's peak KV page
        footprint (0 = dense decoder / skip the page check)."""
        pending = self.scheduler.pending_count()
        if pending >= self.max_pending:
            self.shed_total += 1
            return (
                False,
                self.scheduler.estimate_retry_after_s(),
                f"gateway saturated: {pending} pending >= "
                f"max_pending {self.max_pending}",
            )
        if self._server_queue_depth > self.max_server_queue:
            self.shed_total += 1
            return (
                False,
                self.scheduler.estimate_retry_after_s(),
                f"expert servers saturated: worst advertised queue depth "
                f"{self._server_queue_depth:.0f} > {self.max_server_queue:.0f}",
            )
        if pages_needed > 0:
            headroom = self.scheduler.free_page_headroom()
            if headroom is not None and pages_needed > headroom:
                self.shed_total += 1
                self.shed_pages_total += 1
                return (
                    False,
                    self.scheduler.estimate_retry_after_s(),
                    f"KV page pressure: stream needs {pages_needed} pages, "
                    f"pool headroom {max(0, headroom)}",
                )
        self.admitted_total += 1
        return True, None, None

    def stats(self) -> dict:
        return {
            "max_pending": self.max_pending,
            "max_server_queue": self.max_server_queue,
            "server_queue_depth": self._server_queue_depth,
            "shed_total": self.shed_total,
            "shed_pages_total": self.shed_pages_total,
            "admitted_total": self.admitted_total,
            "load_refresh_failures": self.load_refresh_failures,
        }
