"""Shared client-side RPC machinery: one background loop + pool registry.

All client stubs (RemoteExpert, RemoteMixtureOfExperts) in a process share a
single asyncio loop thread and a per-endpoint connection-pool registry —
the replacement for the reference's thread-per-call dispatch.  The port's
copy of the JAX package's ``client/rpc.py``; its one omission is
``ensure_sync_cpu_dispatch``, which exists only for an XLA:CPU
host-callback deadlock that ``torch.autograd.Function`` cannot meet.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import logging
import os
import threading
import time
from typing import Any, Callable, Coroutine, Optional

from learning_at_home_tpu_torch.utils import sanitizer
from learning_at_home_tpu_torch.utils.asyncio_utils import BackgroundLoop
from learning_at_home_tpu_torch.utils.connection import PoolRegistry, force_protocol_v1

logger = logging.getLogger(__name__)

_lock = sanitizer.lock("client.rpc.state")
_loop: Optional[BackgroundLoop] = None
_registry: Optional[PoolRegistry] = None

# Dispatch data-path regime.  "pipelined" (default): serialization happens
# on the caller's host thread (pack-once fan-out, WireTensors), frames go
# out via vectored writes, and connections negotiate protocol v2
# multiplexing.  "legacy": the pre-PR-2 path — per-call wire_cast +
# pack_message ON the client event loop, one RPC per socket (protocol v1
# forced).  Kept alive as the same-session A/B baseline (bench.py) and as
# an escape hatch (LAH_CLIENT_PIPELINE=0).
_dispatch_mode = (
    "legacy"
    if os.environ.get("LAH_CLIENT_PIPELINE", "1") in ("0", "legacy")
    else "pipelined"
)
if _dispatch_mode == "legacy":
    force_protocol_v1(True)


def dispatch_mode() -> str:
    return _dispatch_mode


def set_dispatch_mode(mode: str) -> None:
    """Switch the client dispatch regime at runtime (bench A/B)."""
    global _dispatch_mode
    if mode not in ("pipelined", "legacy"):
        raise ValueError(f"dispatch mode must be pipelined|legacy, got {mode!r}")
    _dispatch_mode = mode
    force_protocol_v1(mode == "legacy")


# --------------------------------------------------------------------------
# dispatch-wait watchdog (ISSUE 5 satellite): the jitted-client
# io_callback deadlock class (ROUND5_NOTES "hazards") presents as a
# SILENT hang — the host thread blocks in client_loop().run() forever
# while the loop waits on buffers the blocked thread will never release.
# A watchdog timer armed around the dispatch wait turns that into a
# diagnosable event: one WARNING per process, with every thread's stack.
# --------------------------------------------------------------------------

_watchdog_lock = sanitizer.lock("client.rpc.watchdog")
_watchdog_fired = False


def reset_dispatch_watchdog() -> None:
    """Re-arm the once-per-process watchdog warning (test hook)."""
    global _watchdog_fired
    with _watchdog_lock:
        _watchdog_fired = False


def _all_thread_stacks() -> str:
    import sys
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


def _watchdog_fire(budget: float, what: str) -> None:
    global _watchdog_fired
    with _watchdog_lock:
        if _watchdog_fired:
            return
        _watchdog_fired = True
    # a fired watchdog is exactly the moment the recent-event ring matters:
    # persist it before anyone restarts the process (ISSUE 19 layer 4)
    from learning_at_home_tpu_torch.utils import flight

    flight.record(
        "client", "dispatch_watchdog", what=what, budget_s=round(budget, 3)
    )
    flight.dump("dispatch_watchdog")
    logger.warning(
        "dispatch-wait watchdog: %s has waited > %.2fs (watchdog budget = "
        "LAH_DISPATCH_WATCHDOG_MULT x pool RTT-EMA).  If this never "
        "completes, suspect the jitted-client io_callback deadlock "
        "(ROUND5_NOTES hazards).  Thread stacks:\n%s",
        what, budget, _all_thread_stacks(),
    )


@contextlib.contextmanager
def dispatch_wait_watchdog(rtt_ema: Optional[float], what: str = "dispatch"):
    """Arm a timer for the enclosed blocking dispatch wait.

    Budget = ``LAH_DISPATCH_WATCHDOG_MULT`` (default 20) x the slowest
    involved pool's RTT EMA, floored at ``LAH_DISPATCH_WATCHDOG_MIN_S``
    (default 5 s — cold pools' first exchanges legitimately include
    connects and server-side warmup compiles).  Disabled when the
    multiple is <= 0 or no RTT has ever been measured (nothing to scale
    from).  Firing logs ONE warning per process with all thread stacks
    and never interrupts the wait — diagnosis, not intervention."""
    if _watchdog_fired or rtt_ema is None:
        # once the single warning is out there is nothing left to arm —
        # don't pay a Timer-thread create/cancel per dispatch forever
        yield
        return
    try:
        mult = float(os.environ.get("LAH_DISPATCH_WATCHDOG_MULT", "20"))
        floor = float(os.environ.get("LAH_DISPATCH_WATCHDOG_MIN_S", "5"))
    except ValueError:
        mult, floor = 20.0, 5.0
    if mult <= 0:
        yield
        return
    budget = max(mult * rtt_ema, floor)
    timer = threading.Timer(budget, _watchdog_fire, args=(budget, what))
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


# --------------------------------------------------------------------------
# future-based dispatch core (ISSUE 7): the fire half of a dispatch
# submits its quorum fan-out coroutine to the lah-client loop and
# immediately returns a joinable DispatchFuture — the caller's host
# thread is free to keep computing anything not data-dependent on the
# replies, and joins as late as the dependency allows.  The ROUND5
# io_callback-hang hazard class is retired BY CONSTRUCTION here: the
# fire path never waits on the loop at all, and the join is one bounded
# wait on a concurrent future resolved by the loop thread (no nested
# loop waits, and — in pipelined mode — a hard timeout that turns a
# stalled pool into a diagnosable error instead of a silent hang; the
# legacy A/B arm keeps the PR-5 watchdog + unbounded wait semantics).
# --------------------------------------------------------------------------

# extra slack on top of (rpc_timeout + timeout_after_k_min) before a
# pipelined join gives up on its fan-out: first exchanges against a cold
# server legitimately include connects and warmup compiles
JOIN_GRACE_S = float(os.environ.get("LAH_DISPATCH_JOIN_GRACE_S", "30"))


class DispatchJoinTimeout(RuntimeError):
    """A DispatchFuture.join exceeded its hard deadline: the fan-out
    coroutine never resolved.  The fan-out task is cancelled before this
    is raised, so the loop is left clean.  Suspect a stalled/black-holed
    pool (a peer accepting connections but never replying) — the
    condition the legacy path's dispatch-wait watchdog could only WARN
    about is a clean, catchable error on the future-based path."""


class DispatchFuture:
    """A joinable in-flight expert fan-out.

    Created on the caller's host thread by the fire half of a dispatch
    (``RemoteMixtureOfExperts.dispatch_async`` / ``backward_async``)
    AFTER payload serialization: construction submits the quorum fan-out
    coroutine to the ``lah-client`` loop and returns immediately — it
    never blocks on the loop (sanitizer site ``rpc.DispatchFuture.fire``
    would be the place to assert that, but construction does no waiting
    by construction).  :meth:`join` blocks the calling host thread until
    the fan-out resolves, runs the supplied finalizer on its results,
    and reports how much of the in-flight window the caller actually
    hid behind other work (the ``overlap fraction`` observable).

    Join semantics by dispatch mode:

    - ``join_timeout`` set (pipelined): hard deadline; on expiry the
      fan-out task is cancelled and :class:`DispatchJoinTimeout` raises.
    - ``join_timeout`` None (legacy A/B arm): unbounded wait guarded by
      the once-per-process ``dispatch_wait_watchdog`` — the exact PR-5
      behavior, kept as the regression baseline.
    """

    def __init__(
        self,
        kind: str,
        coro: Coroutine,
        finalize: Callable[[Any], Any],
        *,
        join_timeout: Optional[float] = None,
        watchdog_rtt: Optional[float] = None,
        what: str = "dispatch",
        on_join_exit: Optional[Callable[["DispatchFuture"], None]] = None,
    ):
        self.kind = kind
        self._finalize = finalize
        self._join_timeout = join_timeout
        self._watchdog_rtt = watchdog_rtt
        self._what = what
        self._on_join_exit = on_join_exit
        self.joined = False
        self.cancelled = False
        # overlap accounting (read by the finalizer/owner after join):
        # fired_at -> completed_at is the in-flight window; the slice of
        # it NOT spent blocked inside join() was hidden behind caller
        # compute.  completed_at is stamped on the loop thread the moment
        # the fan-out coroutine settles (plain float store — no lock; the
        # join thread only reads it after the future resolved).
        self.completed_at: Optional[float] = None
        self.blocked_s: float = 0.0
        self.fired_at = time.monotonic()
        self._cf = client_loop().submit(self._timed(coro))

    async def _timed(self, coro: Coroutine):
        try:
            return await coro
        finally:
            self.completed_at = time.monotonic()

    def done(self) -> bool:
        return self._cf.done()

    def cancel(self) -> None:
        """Best-effort cancel of the in-flight fan-out (the
        ticket-eviction path).  Marks the future consumed and runs the
        join-exit hook once, so the owner's in-flight accounting drains
        — an evicted, never-joined ticket must not leak the
        ``inflight_dispatches`` gauge."""
        self.cancelled = True
        self._cf.cancel()
        if not self.joined:
            self.joined = True
            if self._on_join_exit is not None:
                self._on_join_exit(self)

    # ---- overlap observables (valid after join) ----

    def inflight_s(self) -> float:
        end = self.completed_at
        if end is None:
            end = time.monotonic()
        return max(end - self.fired_at, 0.0)

    def overlap_fraction(self) -> float:
        """Fraction of the in-flight window hidden behind caller compute
        (0.0 = the caller joined immediately and ate the whole wait —
        the serial regime; → 1.0 = the replies were already in when the
        caller finally joined)."""
        inflight = self.inflight_s()
        if inflight <= 0.0:
            return 0.0
        return max(0.0, min(1.0, (inflight - self.blocked_s) / inflight))

    @sanitizer.runs_on("host", site="rpc.DispatchFuture.join")
    def join(self, timeout: Optional[float] = None) -> Any:
        """Block this host thread until the fan-out resolves; return the
        finalizer's output.  Never call from a loop thread: the wait
        would starve the loop that must resolve it (asserted via the
        sanitizer site above; ``BackgroundLoop.run``'s always-on guard
        covers the submit-side shape)."""
        if self.joined:
            raise RuntimeError(f"{self.kind} DispatchFuture joined twice")
        self.joined = True
        deadline = timeout if timeout is not None else self._join_timeout
        t_block = time.monotonic()
        try:
            if deadline is None:
                # legacy arm: unbounded wait under the PR-5 watchdog —
                # the hang class stays diagnosable there, not fatal
                with dispatch_wait_watchdog(
                    self._watchdog_rtt, what=self._what
                ):
                    results = self._cf.result()
            else:
                try:
                    results = self._cf.result(deadline)
                except concurrent.futures.TimeoutError:
                    self._cf.cancel()
                    raise DispatchJoinTimeout(
                        f"{self._what}: fan-out did not resolve within "
                        f"{deadline:.1f}s of join — cancelled the in-flight "
                        "task.  A pool is stalled (accepting but never "
                        "replying), or the join deadline is below the "
                        "server's warmup-compile window; see "
                        "LAH_DISPATCH_JOIN_GRACE_S."
                    ) from None
        finally:
            self.blocked_s = time.monotonic() - t_block
            if self._on_join_exit is not None:
                self._on_join_exit(self)
        return self._finalize(results)


def client_loop() -> BackgroundLoop:
    global _loop
    with _lock:
        if _loop is None or _loop._shutdown:
            _loop = BackgroundLoop(name="lah-client")
        return _loop


def pool_registry() -> PoolRegistry:
    global _registry
    with _lock:
        if _registry is None:
            _registry = PoolRegistry()
        return _registry


def reset_client_rpc() -> None:
    """Close all client connections and the loop (test teardown helper)."""
    global _loop, _registry
    # the caller is declaring the client side idle: every fired dispatch
    # should have been joined or cancelled by now — audit the gauges
    # before tearing the loop down (sanitizer-gated, no-op in production)
    sanitizer.quiesce_point("client")
    with _lock:
        if _registry is not None:
            registry = _registry
            _registry = None
            if _loop is not None and not _loop._shutdown:

                async def _close():
                    registry.close()

                try:
                    _loop.run(_close(), timeout=5)
                except Exception as e:
                    # best-effort teardown, but never silent (R6): a close
                    # that fails repeatedly is an FD leak worth seeing
                    logger.debug("client pool close failed during reset: "
                                 "%s: %s", type(e).__name__, e)
        if _loop is not None:
            _loop.shutdown()
            _loop = None
