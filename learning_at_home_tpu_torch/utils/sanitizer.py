"""Runtime concurrency sanitizer (ISSUE 6, layer 2).

The swarm's correctness story rests on threading invariants that are easy
to break silently: serialization must stay OFF the client/serving event
loops (PR 1/2/5), batch stacking belongs to the Runtime thread, and a
host thread blocking on a loop that needs that same thread is the exact
shape of the known jitted-client ``io_callback`` hang (ROUND5 hazards).
This module makes those invariants *checked* instead of *hoped for*:

- :func:`runs_on` — first-class thread-identity assertions on the
  hot-path entry points (``BatchJob.stack``, ``EncodedBatch.encode``,
  ``LazyDecode`` dequantize, ``pack_frames``, averaging chunk prep),
  replacing the ad-hoc thread-tracking monkeypatches the regression
  tests used to carry;
- an **event-loop stall detector** — every loop callback is timed; any
  callback holding a loop longer than ``LAH_SANITIZE_STALL_MS`` is
  recorded with the blocked frame's stack (captured live by a monitor
  thread, so a callback that NEVER returns still gets diagnosed);
- a **lock-acquisition graph** — locks created through :func:`lock`
  record which locks were held when they were acquired; any cycle in
  that graph across the Runtime/host/loop threads is flagged as a
  deadlock hazard the moment the second edge appears, no actual
  deadlock required;
- **quiesce-point audits** (ISSUE 14) — components register a callable
  (:func:`register_quiesce_audit`) that returns the list of resource
  leaks visible at a moment the component claims to be idle (gauge not
  drained, slot/page accounting off baseline, refcounts not summing to
  pool occupancy).  :func:`quiesce_point` runs the matching audits and
  records each leak as a ``kind="quiesce"`` violation — surfaced in
  :func:`summary` and failed by the conftest guard like any other
  violation;
- a **lock observer hook** (:func:`set_lock_observer`) — the lah-verify
  interleaving explorer (analysis/verify.py) subscribes to tracked-lock
  acquire/release events to learn each operation's shared-site
  footprint for DPOR-style pruning.

Everything is gated on ``LAH_SANITIZE=1`` **at import time**: with the
flag off (production), :func:`runs_on` returns the function unchanged and
:func:`lock` returns a plain ``threading.Lock`` — the hot paths carry
zero extra work.  The test suite turns it on by default (tests/conftest),
so tier-1 runs every dispatch under the checks.

Violations are RECORDED (and logged), never raised: a sanitizer must
diagnose without changing control flow.  Tests assert
``violations() == []`` (the conftest guard does it per test) and seeded
violation tests drain their expected findings via
:func:`expect_violations`.  See docs/CONCURRENCY.md for the thread/loop
inventory and the lock-order contract these checks encode.
"""

from __future__ import annotations

import asyncio
import functools
import os
import sys
import threading
import time
import traceback
import weakref
from contextlib import contextmanager
from typing import Callable, Optional

import logging

logger = logging.getLogger(__name__)

_ENABLED = os.environ.get("LAH_SANITIZE", "") not in ("", "0")

# loop-thread name prefixes (BackgroundLoop instances); everything else
# is "host" unless it's the Runtime's device thread
_LOOP_PREFIXES = (
    "lah-client", "lah-server", "lah-metrics", "lah-avg", "lah-dht",
    "lah-telemetry", "lah-loop",
)
_RUNTIME_PREFIX = "lah-runtime"

_state_lock = threading.Lock()
_violations: list[dict] = []
_violation_counts: dict[tuple[str, str], int] = {}  # (kind, site) -> total
_violations_dropped = 0
_site_counts: dict[tuple[str, str], int] = {}
_lock_edges: dict[tuple[str, str], int] = {}
_stalls = {"count": 0, "max_ms": 0.0, "last": None}
_tls = threading.local()
# reentrancy guard for the flight-recorder violation hook (see
# _record_violation): flight's own lock is sanitizer-instrumented
_flight_hook = threading.local()

# per-site log throttle so a hot-path regression warns, not firehoses
_LOG_CAP_PER_SITE = 3
# stored-violation cap: a regression firing once per dispatch during a
# long soak must not grow memory without bound (the per-(kind,site)
# totals keep counting past the cap; summary() reports the drop count)
_MAX_STORED_VIOLATIONS = 500


def enabled() -> bool:
    """True when the sanitizer was armed (``LAH_SANITIZE=1``) at import."""
    return _ENABLED


def thread_class(name: Optional[str] = None) -> str:
    """Classify a thread by name: ``runtime`` (the device thread), the
    loop's prefix for event-loop threads (``lah-client``, ...), ``host``
    for everything else (main thread, io_callback hosts, executors)."""
    if name is None:
        name = threading.current_thread().name
    if name.startswith(_RUNTIME_PREFIX):
        return "runtime"
    for p in _LOOP_PREFIXES:
        if name.startswith(p):
            return p
    return "host"


def _on_running_loop() -> bool:
    """True when the current thread is EXECUTING an asyncio event loop
    (inside a coroutine or loop callback) — the precise condition under
    which blocking work stalls every connection that loop serves."""
    try:
        asyncio.get_running_loop()
        return True
    except RuntimeError:
        return False


def _allowed_sites() -> set:
    s = getattr(_tls, "allowed", None)
    if s is None:
        s = _tls.allowed = set()
    return s


@contextmanager
def allowed(*sites: str):
    """Suppress checks for ``sites`` within this scope on this thread —
    the runtime twin of the lint's ``# lah-lint: ignore[..]`` annotation,
    for the few deliberate exceptions (e.g. the serving loop's inline
    encode of sub-256 KiB replies, the averaging handler's eager decode
    of bounded chunks).  Every use should carry a comment saying why."""
    acl = _allowed_sites()
    added = [s for s in sites if s not in acl]
    acl.update(added)
    try:
        yield
    finally:
        acl.difference_update(added)


def _record_violation(kind: str, site: str, detail: str) -> None:
    global _violations_dropped
    with _state_lock:
        n_at_site = _violation_counts.get((kind, site), 0)
        _violation_counts[(kind, site)] = n_at_site + 1
        if len(_violations) < _MAX_STORED_VIOLATIONS:
            _violations.append(
                {
                    "kind": kind,
                    "site": site,
                    "thread": threading.current_thread().name,
                    "detail": detail,
                }
            )
        else:
            _violations_dropped += 1
    if n_at_site < _LOG_CAP_PER_SITE:
        logger.warning(
            "sanitizer %s violation at %s (thread %s): %s",
            kind, site, threading.current_thread().name, detail,
        )
    # flight-recorder hook (ISSUE 19 layer 4): a violation is a dump
    # trigger — the ring holds the events that led here.  Lazy import
    # (flight builds its lock through this module) plus a thread-local
    # reentrancy guard: recording the event takes the flight lock, and a
    # violation raised BY that acquisition must not recurse back in.
    if getattr(_flight_hook, "active", False):
        return
    _flight_hook.active = True
    try:
        from learning_at_home_tpu_torch.utils import flight

        flight.record(
            "sanitizer", "violation", violation_kind=kind, site=site,
            detail=detail[:200],
        )
        flight.dump("sanitizer_violation")
    finally:
        _flight_hook.active = False


def check(kind: str, site: str) -> None:
    """Inline thread-identity assertion (the body behind :func:`runs_on`).

    Kinds:

    - ``"host"`` — must NOT be executing on any asyncio event loop
      (io_callback host threads, executors and the Runtime thread all
      qualify; loop callbacks/coroutines do not);
    - ``"runtime"`` — same loop-freedom check, used on sites whose
      production home is the ``lah-runtime`` device thread (the site
      stats record which class actually ran it, so tests can assert the
      runtime really did the work);
    - ``"not:<prefix>"`` — must not run on a thread whose name starts
      with ``<prefix>`` (e.g. the device thread must never serialize
      wire frames).
    """
    if not _ENABLED:
        return
    tclass = thread_class()
    with _state_lock:
        key = (site, tclass)
        _site_counts[key] = _site_counts.get(key, 0) + 1
    if site in _allowed_sites():
        return
    if kind in ("host", "runtime"):
        if _on_running_loop():
            _record_violation(
                "thread", site,
                f"expected {kind} thread, ran on event loop "
                f"({threading.current_thread().name})",
            )
    elif kind.startswith("not:"):
        if threading.current_thread().name.startswith(kind[4:]):
            _record_violation(
                "thread", site, f"must not run on {kind[4:]!r} threads"
            )
    else:  # pragma: no cover - construction-time misuse
        raise ValueError(f"unknown runs_on kind {kind!r}")


def runs_on(kind: str, site: Optional[str] = None) -> Callable:
    """Decorator form of :func:`check`.  With the sanitizer disabled the
    function is returned UNCHANGED — zero wrapper, zero hot-path cost."""

    def deco(fn: Callable) -> Callable:
        if not _ENABLED:
            return fn
        where = site or getattr(fn, "__qualname__", fn.__name__)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            check(kind, where)
            return fn(*args, **kwargs)

        return wrapper

    return deco


# --------------------------------------------------------------------------
# violation surface (tests, conftest guard, gate summary)
# --------------------------------------------------------------------------


def violations() -> list[dict]:
    with _state_lock:
        return list(_violations)


def violation_count() -> int:
    with _state_lock:
        return len(_violations)


def clear_violations() -> None:
    global _violations_dropped
    with _state_lock:
        _violations.clear()
        _violation_counts.clear()
        _violations_dropped = 0


@contextmanager
def expect_violations(*sites: str):
    """Capture violations recorded inside the scope and REMOVE them from
    the global list (so the conftest zero-violation guard stays green):
    the seeded-violation tests assert on the yielded list after exit.

    Pass the seeded ``sites`` (prefix match) to drain ONLY them — a
    genuine violation from an unrelated site firing inside the scope
    (e.g. on a background loop while a seeded test runs) then still
    reaches the guard and the session summary instead of being silently
    swallowed as 'expected'.  With no sites, everything in-scope drains
    (generic use)."""

    def _expected(v: dict) -> bool:
        return not sites or any(v["site"].startswith(s) for s in sites)

    with _state_lock:
        start = len(_violations)
    captured: list[dict] = []
    try:
        yield captured
    finally:
        with _state_lock:
            in_scope = _violations[start:]
            keep = [v for v in in_scope if not _expected(v)]
            captured.extend(v for v in in_scope if _expected(v))
            _violations[start:] = keep
            # drain the totals too: seeded (expected) violations must not
            # surface in the session summary as real findings
            for v in captured:
                key = (v["kind"], v["site"])
                n = _violation_counts.get(key, 0)
                if n <= 1:
                    _violation_counts.pop(key, None)
                else:
                    _violation_counts[key] = n - 1


def site_stats() -> dict:
    """``{site: {thread_class: calls}}`` — lets a regression test assert
    both halves of an off-loop contract: the work really RAN, and it ran
    on the right class of thread."""
    out: dict[str, dict[str, int]] = {}
    with _state_lock:
        for (site, tclass), n in _site_counts.items():
            out.setdefault(site, {})[tclass] = n
    return out


def reset_site_stats() -> None:
    with _state_lock:
        _site_counts.clear()


def summary() -> dict:
    """The gate-facing roll-up: printed by the pytest session hook and
    exportable via ``LAH_SANITIZE_SUMMARY=<path>`` (tools/collect_gate)."""
    with _state_lock:
        thread_v = sum(
            n for (kind, _), n in _violation_counts.items()
            if kind == "thread"
        )
        cycles = sum(
            n for (kind, _), n in _violation_counts.items()
            if kind == "lock-cycle"
        )
        quiesce = sum(
            n for (kind, _), n in _violation_counts.items()
            if kind == "quiesce"
        )
        return {
            "enabled": _ENABLED,
            "thread_violations": thread_v,
            "lock_cycles": cycles,
            "quiesce_leaks": quiesce,
            "violations_dropped": _violations_dropped,
            "lock_edges": len(_lock_edges),
            "stalls": _stalls["count"],
            "max_stall_ms": round(_stalls["max_ms"], 2),
            "sites": len({site for site, _ in _site_counts}),
        }


# --------------------------------------------------------------------------
# quiesce-point audits: resource-leak checks at claimed-idle moments
# --------------------------------------------------------------------------

# site -> audit callable (or weakref.WeakMethod for bound methods, so a
# registered component can be garbage-collected without unregistering —
# the same lifetime discipline as metrics collectors)
_quiesce_audits: dict[str, object] = {}


def register_quiesce_audit(site: str, fn: Callable[[], list]) -> None:
    """Register ``fn`` to run at matching :func:`quiesce_point` calls.
    ``fn`` returns a list of leak descriptions (empty = clean).  Bound
    methods are held weakly; a dead referent unregisters itself.  No-op
    with the sanitizer disabled (zero production cost)."""
    if not _ENABLED:
        return
    ref: object = fn
    if hasattr(fn, "__self__"):
        ref = weakref.WeakMethod(fn)
    with _state_lock:
        if len(_quiesce_audits) > 64:
            # high-churn registrants (the lah-verify explorer builds
            # hundreds of short-lived schedulers) leave dead WeakMethods
            # behind; sweep them here so the registry stays bounded
            for k in [
                k for k, r in _quiesce_audits.items()
                if isinstance(r, weakref.WeakMethod) and r() is None
            ]:
                del _quiesce_audits[k]
        _quiesce_audits[site] = ref


def unregister_quiesce_audit(site: str) -> None:
    with _state_lock:
        _quiesce_audits.pop(site, None)


def quiesce_point(prefix: str = "") -> list[str]:
    """Run every registered audit whose site starts with ``prefix`` (all
    of them for "").  Each returned leak is recorded as a ``quiesce``
    violation at that site and the combined list is returned.  An audit
    that raises is itself a finding — a leak checker that cannot run is
    not a clean bill."""
    if not _ENABLED:
        return []
    with _state_lock:
        matched = [
            (site, ref) for site, ref in _quiesce_audits.items()
            if site.startswith(prefix)
        ]
    leaks: list[str] = []
    dead: list[str] = []
    for site, ref in matched:
        fn = ref
        if isinstance(ref, weakref.WeakMethod):
            fn = ref()
            if fn is None:
                dead.append(site)
                continue
        try:
            found = list(fn() or [])
        except Exception as e:  # the audit itself failing is a finding
            found = [f"audit raised {type(e).__name__}: {e}"]
        for leak in found:
            _record_violation("quiesce", site, leak)
            leaks.append(f"{site}: {leak}")
    if dead:
        with _state_lock:
            for site in dead:
                _quiesce_audits.pop(site, None)
    return leaks


# --------------------------------------------------------------------------
# lock-acquisition graph: order violations flagged before they deadlock
# --------------------------------------------------------------------------


def _held_stack() -> list:
    s = getattr(_tls, "held", None)
    if s is None:
        s = _tls.held = []
    return s


def _add_edge(a: str, b: str, a_id: int, b_id: int) -> None:
    """Record 'a held while acquiring b'.  A NEW edge triggers a cycle
    probe: if b can already reach a through existing edges, two threads
    interleaving those chains can deadlock — flag it now, while both
    stacks are innocent.

    Graph nodes are lock NAMES (a class of locks), not instances — every
    ExpertBackend shares ``server.expert_state``.  Re-acquiring the SAME
    instance is reentrancy, not an ordering fact; but nesting two
    *different* instances of one name is the ABBA shape name-level edges
    cannot see (instance order is unconstrained), so it is flagged
    directly."""
    if a == b:
        if a_id != b_id:
            _record_violation(
                "lock-cycle", f"{a}->{b}",
                f"two different {a!r} instances nested — with no defined "
                "instance order, another thread nesting them the other "
                "way around deadlocks (ABBA within one lock class)",
            )
        return  # reentrant same-instance acquire: not an ordering fact
    with _state_lock:
        seen_before = (a, b) in _lock_edges
        _lock_edges[(a, b)] = _lock_edges.get((a, b), 0) + 1
        if seen_before:
            return
        # DFS b ->* a over the edge set (small graph: repo-named locks)
        adj: dict[str, list[str]] = {}
        for (x, y) in _lock_edges:
            adj.setdefault(x, []).append(y)
        stack, seen = [b], set()
        path_found = False
        while stack:
            node = stack.pop()
            if node == a:
                path_found = True
                break
            if node in seen:
                continue
            seen.add(node)
            stack.extend(adj.get(node, ()))
    if path_found:
        _record_violation(
            "lock-cycle",
            f"{a}->{b}",
            f"acquiring {b!r} while holding {a!r} closes a cycle in the "
            "lock graph (reverse path already observed) — deadlock hazard",
        )


def lock_edges() -> dict:
    with _state_lock:
        return dict(_lock_edges)


# Optional subscriber for tracked-lock events.  The lah-verify
# interleaving explorer (analysis/verify.py) sets this to learn each
# operation's shared-site footprint — which named locks an op touches —
# for DPOR-style pruning (only ops with intersecting footprints are
# worth permuting).  Called as fn("acquire"|"release", lock_name) AFTER
# a successful acquire / BEFORE the underlying release.  Must be cheap
# and must not touch tracked locks itself (reentrancy).
_lock_observer: Optional[Callable[[str, str], None]] = None


def set_lock_observer(fn: Callable[[str, str], None]) -> None:
    global _lock_observer
    _lock_observer = fn


def clear_lock_observer() -> None:
    global _lock_observer
    _lock_observer = None


class _TrackedLock:
    """A named lock whose acquisitions feed the ordering graph."""

    __slots__ = ("name", "_real")

    def __init__(self, name: str, real):
        self.name = name
        self._real = real

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held_stack()
        me = id(self)
        for h_name, h_id in held:
            _add_edge(h_name, self.name, h_id, me)
        got = self._real.acquire(blocking, timeout)
        if got:
            held.append((self.name, me))
            obs = _lock_observer
            if obs is not None:
                obs("acquire", self.name)
        return got

    def release(self) -> None:
        held = _held_stack()
        me = (self.name, id(self))
        if me in held:
            # remove the most recent hold; out-of-order release is legal
            for i in range(len(held) - 1, -1, -1):
                if held[i] == me:
                    del held[i]
                    break
        obs = _lock_observer
        if obs is not None:
            obs("release", self.name)
        self._real.release()

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def lock(name: str, reentrant: bool = False):
    """Factory for the repo's named locks.  Sanitizer off → the plain
    ``threading.Lock``/``RLock`` (zero overhead); on → a tracked lock
    feeding the acquisition graph.  Use a stable dotted name — it is the
    node identity docs/CONCURRENCY.md's lock-order table refers to."""
    real = threading.RLock() if reentrant else threading.Lock()
    if not _ENABLED:
        return real
    return _TrackedLock(name, real)


# --------------------------------------------------------------------------
# event-loop stall detector
# --------------------------------------------------------------------------

_STALL_MS = float(os.environ.get("LAH_SANITIZE_STALL_MS", "100"))
# thread ident -> [start_monotonic, callback_obj, claim-state]
# claim-state: None (unclaimed) -> _CLAIMED (an owner is recording) ->
# the occurrence dict.  The monitor and the completing callback race to
# report one stall; _claim_stall arbitrates so it is counted exactly
# once and the final duration lands on the right occurrence.  The
# callback OBJECT is stored (not its repr): repr is only computed for
# the rare stalled callback, never per loop iteration.
_active_callbacks: dict[int, list] = {}
_CLAIMED = object()
_claim_lock = threading.Lock()
_monitor_started = False


def _claim_stall(entry: list) -> bool:
    """Exactly one of {monitor, completing callback} may record a given
    stall; winner transitions the entry's claim-state off None."""
    with _claim_lock:
        if entry[2] is not None:
            return False
        entry[2] = _CLAIMED
        return True


def _record_stall(dur_ms: float, what: str, stack: Optional[str]) -> dict:
    """Returns the occurrence record so the completing callback can
    refresh ITS final duration (two loops can stall concurrently — the
    'last' pointer may have moved on by then)."""
    occurrence = {"ms": round(dur_ms, 2), "callback": what, "stack": stack}
    with _state_lock:
        _stalls["count"] += 1
        if dur_ms > _stalls["max_ms"]:
            _stalls["max_ms"] = dur_ms
        _stalls["last"] = occurrence
    logger.warning(
        "sanitizer: event-loop callback stalled %.0f ms (> %.0f ms): %s%s",
        dur_ms, _STALL_MS, what,
        f"\nblocked at:\n{stack}" if stack else "",
    )
    return occurrence


def stall_stats() -> dict:
    with _state_lock:
        return {
            "count": _stalls["count"],
            "max_ms": round(_stalls["max_ms"], 2),
            "last": _stalls["last"],
        }


def _monitor() -> None:
    """Samples in-flight loop callbacks; one that exceeds the stall
    budget gets its LIVE stack captured — this is what turns a callback
    that never returns (the deadlock class) into a diagnosable event
    instead of a silent hang."""
    poll = max(_STALL_MS / 2000.0, 0.01)
    while True:
        time.sleep(poll)
        now = time.monotonic()
        for ident, entry in list(_active_callbacks.items()):
            # a detector must never die of its own diagnostics: a
            # throwing __repr__ or a frame torn down mid-format would
            # otherwise silently end stall detection for the process
            try:
                start, cb, claim = entry
                if claim is not None or (now - start) * 1000.0 < _STALL_MS:
                    continue
                if not _claim_stall(entry):
                    continue  # the callback completed and reported itself
                frame = sys._current_frames().get(ident)
                # only attach the stack while the callback is still the
                # one running on that thread — a just-completed
                # callback's thread may already be doing something else
                if _active_callbacks.get(ident) is not entry:
                    frame = None
                stack = (
                    "".join(traceback.format_stack(frame)) if frame else None
                )
                entry[2] = _record_stall(
                    (now - start) * 1000.0, _safe_repr(cb), stack
                )
            except Exception:  # pragma: no cover - defensive
                logger.exception("sanitizer stall monitor sample failed")


def _safe_repr(obj) -> str:
    try:
        return repr(obj)
    except Exception:
        return f"<unreprable {type(obj).__name__}>"


def _install_stall_detector() -> None:
    """Wrap ``asyncio.Handle._run`` so every loop callback is timed.
    Covers the stdlib loop (all BackgroundLoops here; uvloop, when
    present, bypasses Handle and is not monitored — documented in
    docs/CONCURRENCY.md)."""
    global _monitor_started
    if _monitor_started:
        return
    _monitor_started = True
    orig_run = asyncio.Handle._run

    def monitored_run(self):  # noqa: ANN001 - asyncio internal signature
        ident = threading.get_ident()
        entry = [time.monotonic(), getattr(self, "_callback", self), None]
        _active_callbacks[ident] = entry
        try:
            return orig_run(self)
        finally:
            # this block runs INSIDE the loop's Handle._run: any escape
            # here would kill the loop thread being instrumented — the
            # diagnostics must be infallible from the loop's perspective
            try:
                _active_callbacks.pop(ident, None)
                dur_ms = (time.monotonic() - entry[0]) * 1000.0
                if dur_ms >= _STALL_MS:
                    if _claim_stall(entry):
                        # first reporter (the monitor never sampled us,
                        # or lost the race): count once, no live stack
                        _record_stall(dur_ms, _safe_repr(entry[1]), None)
                    elif isinstance(entry[2], dict):
                        # the monitor already counted this stall
                        # mid-flight (with a live stack); refresh THIS
                        # occurrence's final duration — never whatever
                        # 'last' points at now (another loop may have
                        # stalled since)
                        with _state_lock:
                            if dur_ms > _stalls["max_ms"]:
                                _stalls["max_ms"] = dur_ms
                            entry[2]["ms"] = round(dur_ms, 2)
                    # else: monitor holds the claim mid-record — it will
                    # finish the occurrence; dropping the refresh is fine
            except Exception:  # pragma: no cover - defensive
                logger.exception("sanitizer stall bookkeeping failed")

    asyncio.Handle._run = monitored_run
    threading.Thread(
        target=_monitor, name="lah-sanitize-monitor", daemon=True
    ).start()


if _ENABLED:
    _install_stall_detector()
