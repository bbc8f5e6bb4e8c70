"""The virtual clock and its seams.

The port's copy of ``learning_at_home_tpu/sim/clock.py``; its seams patch
the port's modules.  The gateway scheduler
and the server lifecycle read time through module-level ``_monotonic`` /
``_sleep`` indirections precisely so a test can swap a deterministic
clock in.  This module promotes that ad-hoc seam into a first-class
contract:

- :class:`VirtualClock` — one mutable ``now`` shared by every consumer.
  Calling the instance advances by ``step`` and returns the new ``now``
  (the shape of the JAX package's verifier worlds);
  :meth:`VirtualClock.monotonic` reads without advancing (the macro-sim
  shape, where ONLY the event loop advances time).
- :func:`installed_clock` — a context manager that patches every known
  clock seam in the codebase (scheduler, admission, lifecycle, DHT
  maintenance + routing-table staleness, client routing TTLs, and the
  DHT wall-clock ``get_dht_time`` used for record expirations) and
  restores them on exit.  The full seam list is the contract — new
  time reads in covered modules MUST go
  through the module's ``_monotonic`` seam, not ``time.monotonic``.
- :class:`VirtualClockEventLoop` — an asyncio event loop whose timers
  run on the virtual clock: ``select(timeout)`` ADVANCES the clock by
  ``timeout`` instead of blocking, so ``asyncio.sleep`` / ``wait_for``
  / timeout handles all fire deterministically and a simulated hour
  costs only the CPU of the callbacks inside it.  Single-threaded with
  a FIFO ready queue and a deterministic timer heap, so a seeded
  scenario replays byte-identically.
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib
import selectors
import time
from typing import Iterator, Optional

# Epoch for the virtual wall clock backing ``get_dht_time`` — an
# arbitrary fixed instant so DHT record expirations are deterministic
# and never race the host's real wall clock.
DEFAULT_EPOCH = 1_700_000_000.0


class VirtualClock:
    """Deterministic clock with both read styles.

    ``step`` exists for the verifier's worlds, which patch the INSTANCE
    itself over ``_monotonic`` so every read nudges time forward and
    TTL/pacing branches get exercised.  The macro-sim uses ``step=0``:
    reads are pure, and time advances only through the event loop
    (:class:`VirtualClockEventLoop`) or an explicit :meth:`advance`.
    """

    def __init__(self, step: float = 1.0, *, start: float = 0.0,
                 epoch: float = DEFAULT_EPOCH):
        self.now = float(start)
        self.step = float(step)
        self.epoch = float(epoch)

    def __call__(self) -> float:
        self.now += self.step
        return self.now

    # ---- the macro-sim read/advance surface ----

    def monotonic(self) -> float:
        """Read without advancing (drop-in for ``time.monotonic``)."""
        return self.now

    def time(self) -> float:
        """Virtual wall clock (drop-in for ``time.time`` /
        ``get_dht_time``): a fixed epoch plus virtual elapsed time."""
        return self.epoch + self.now

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` (negative deltas are ignored —
        the clock is monotonic by construction)."""
        if dt > 0:
            self.now += float(dt)
        return self.now

    def sleep(self, dt: float) -> None:
        """Synchronous sleep = pure time advance (drop-in for the
        ``lifecycle._sleep`` seam)."""
        self.advance(dt)


class WallClock:
    """The production clock behind the same surface, so code written
    against the seam (e.g. ``dht_swarm_sim.run_size``) runs unchanged
    on real time."""

    monotonic = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)
    time = staticmethod(time.time)

    def __call__(self) -> float:
        return time.monotonic()


# ---- the seam registry ----
#
# (module, attribute, clock method) triples.  ``installed_clock`` patches
# each module-level seam with the bound clock method and restores the
# original on exit.  Modules are imported lazily so importing sim.clock
# stays cheap.
SEAMS: tuple[tuple[str, str, str], ...] = (
    ("learning_at_home_tpu_torch.gateway.scheduler", "_monotonic", "monotonic"),
    ("learning_at_home_tpu_torch.gateway.admission", "_monotonic", "monotonic"),
    ("learning_at_home_tpu_torch.server.lifecycle", "_monotonic", "monotonic"),
    ("learning_at_home_tpu_torch.server.lifecycle", "_sleep", "sleep"),
    ("learning_at_home_tpu_torch.dht.node", "_monotonic", "monotonic"),
    ("learning_at_home_tpu_torch.dht.routing", "_monotonic", "monotonic"),
    ("learning_at_home_tpu_torch.client.routing", "_monotonic", "monotonic"),
    # flight-recorder event timestamps + SLO burn-rate windows: both must advance on the virtual clock so sim scenarios emit
    # deterministic flight rings and drive burn-rate transitions without
    # wall-clock waits.
    ("learning_at_home_tpu_torch.utils.flight", "_monotonic", "monotonic"),
    ("learning_at_home_tpu_torch.utils.slo", "_monotonic", "monotonic"),
    # get_dht_time() — record expirations.  Every importer does
    # ``from ... import get_dht_time``, so the function stays put and
    # only its internal _time_source is swapped.
    ("learning_at_home_tpu_torch.utils.timed_storage", "_time_source", "time"),
)


@contextlib.contextmanager
def installed_clock(clock: VirtualClock) -> Iterator[VirtualClock]:
    """Patch every registered clock seam to ``clock``; restore on exit.

    Reentrant-unsafe by design (nested installs would restore in the
    wrong order); the sim installs once around a whole scenario.
    """
    saved: list[tuple[object, str, object]] = []
    try:
        for mod_name, attr, method in SEAMS:
            mod = importlib.import_module(mod_name)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, getattr(clock, method))
        yield clock
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


@contextlib.contextmanager
def installed_entropy(rng) -> Iterator[None]:
    """Patch the DHT's entropy seam (``dht.routing._urandom``) to a
    seeded source; restore on exit.  Bucket-refresh targets steer which
    peers a lookup visits, so OS entropy there is the one remaining
    nondeterminism in an otherwise fully seeded swarm."""
    import learning_at_home_tpu_torch.dht.routing as dht_routing

    def seeded_urandom(n: int) -> bytes:
        return rng.getrandbits(8 * n).to_bytes(n, "big")

    orig = dht_routing._urandom
    dht_routing._urandom = seeded_urandom
    try:
        yield
    finally:
        dht_routing._urandom = orig


class _VirtualTimeSelector(selectors.DefaultSelector):
    """A selector that trades blocking for time travel.

    The sim has no real sockets (the DHT fabric is in-process), so
    ``select(timeout)`` never has events to return; instead it advances
    the shared virtual clock by exactly the timeout the event loop
    computed from its timer heap.  A ``None`` timeout means the loop
    would block forever with nothing scheduled — in a sim that is a
    deadlock, so fail fast instead of spinning.
    """

    def __init__(self, clock: VirtualClock):
        super().__init__()
        self._clock = clock

    def select(self, timeout: Optional[float] = None):
        if timeout is None:
            raise RuntimeError(
                "virtual-time deadlock: event loop blocked with no "
                "scheduled timers and no ready callbacks"
            )
        if timeout > 0:
            self._clock.advance(timeout)
        return []


class VirtualClockEventLoop(asyncio.SelectorEventLoop):
    """``asyncio.SelectorEventLoop`` on virtual time.

    ``time()`` reads the virtual clock, and the selector advances it in
    place of blocking, so every ``asyncio.sleep`` / timeout handle /
    ``loop.call_later`` fires at its virtual deadline with zero wall
    waiting.  Determinism: one thread, FIFO ready queue, and a timer
    heap ordered by (when, tiebreak counter) — all reproducible.
    """

    def __init__(self, clock: VirtualClock):
        super().__init__(selector=_VirtualTimeSelector(clock))
        self.clock = clock

    def time(self) -> float:
        return self.clock.now


def run_virtual(coro, *, clock: Optional[VirtualClock] = None):
    """Run ``coro`` to completion on a fresh virtual-time loop with every
    clock seam installed.  Returns the coroutine's result; the caller
    keeps the clock (pass one in) to read the final virtual time."""
    clock = clock if clock is not None else VirtualClock(step=0.0)
    loop = VirtualClockEventLoop(clock)
    try:
        with installed_clock(clock):
            asyncio.set_event_loop(loop)
            return loop.run_until_complete(coro)
    finally:
        asyncio.set_event_loop(None)
        loop.close()
