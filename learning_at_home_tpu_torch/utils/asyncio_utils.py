"""Async/thread plumbing bridging JAX host code and asyncio networking.

The reference bridges its handler *processes*, pools, and the device loop
with ``mp.Pipe`` + custom mp-aware futures (``hivemind/utils/threading.py``
— SURVEY.md §2; unverifiable refs, mount empty).  The TPU build is
share-nothing in a different way: XLA dispatch releases the GIL, so one
process with (a) asyncio event loops for all networking and (b) a single
device-executor thread per chip gives the same isolation without pickled
pipes.  These helpers are the glue.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import threading
from typing import Any, Awaitable, Callable, Optional

if hasattr(asyncio, "timeout"):  # Python >= 3.11
    asyncio_timeout = asyncio.timeout
else:

    @contextlib.asynccontextmanager
    async def asyncio_timeout(delay: Optional[float]):
        """``asyncio.timeout`` backport for 3.10: cancel the enclosing task
        after ``delay`` and surface it as builtin ``TimeoutError`` (the
        3.11+ exception type callers catch).  ``None`` disables the bound.

        3.10 has no ``Task.uncancel`` bookkeeping, so the timer's cancel
        carries a sentinel message — an EXTERNAL cancellation racing the
        timer keeps its own message and is re-raised as CancelledError,
        never mistaken for (or absorbed as) a timeout."""
        if delay is None:
            yield
            return
        task = asyncio.current_task()
        assert task is not None, "asyncio_timeout must run inside a task"
        sentinel = object()
        timed_out = False

        def _fire() -> None:
            nonlocal timed_out
            timed_out = True
            task.cancel(msg=sentinel)

        def _ours(exc: asyncio.CancelledError) -> bool:
            return bool(exc.args) and exc.args[0] is sentinel

        handle = asyncio.get_running_loop().call_later(delay, _fire)
        try:
            yield
        except asyncio.CancelledError as e:
            if timed_out and _ours(e):
                raise TimeoutError(f"operation exceeded {delay:.3f}s") from None
            raise
        else:
            if timed_out:
                # late-cancel race: the timer fired after the body's last
                # await resolved — absorb OUR pending cancellation so it
                # cannot escape as a stray CancelledError at the caller's
                # next await (the body DID complete in time); an external
                # cancel still propagates
                try:
                    await asyncio.sleep(0)
                except asyncio.CancelledError as e:
                    if not _ours(e):
                        raise
        finally:
            handle.cancel()


def switch_to_uvloop() -> asyncio.AbstractEventLoop:
    """Return a fresh event loop (uvloop if available, stdlib otherwise)."""
    try:  # pragma: no cover - uvloop not present in this environment
        import uvloop

        return uvloop.new_event_loop()
    except ImportError:
        return asyncio.new_event_loop()


def run_in_background(fn: Callable, *args, daemon: bool = True, **kwargs) -> threading.Thread:
    """Run ``fn(*args, **kwargs)`` in a daemon thread; return the thread."""
    thread = threading.Thread(target=fn, args=args, kwargs=kwargs, daemon=daemon)
    thread.start()
    return thread


def run_forever(
    fn: Callable,
    *args,
    stop_event: Optional[threading.Event] = None,
    **kwargs,
) -> tuple[threading.Thread, threading.Event]:
    """Run ``fn`` in a daemon thread, restarting it whenever it returns or
    raises (keep-alive for watchdog-style loops).  Returns (thread, stop):
    set ``stop`` to end the loop after the current iteration."""
    import logging

    logger = logging.getLogger(__name__)
    stop = stop_event if stop_event is not None else threading.Event()

    def loop() -> None:
        while not stop.is_set():
            try:
                fn(*args, **kwargs)
                logger.warning("run_forever target %r returned; restarting", fn)
            except Exception:
                logger.exception("run_forever target %r crashed; restarting", fn)
            stop.wait(0.1)  # never busy-spin a crash loop

    return run_in_background(loop), stop


class BackgroundLoop:
    """An asyncio event loop running forever in a dedicated thread.

    All networking (RPC clients, DHT node, connection handlers) runs on
    background loops; synchronous JAX host code submits coroutines with
    :meth:`run` / :meth:`submit`.  This replaces the reference's
    process-per-component + mp.Pipe architecture.
    """

    def __init__(self, name: str = "lah-loop"):
        self.loop = switch_to_uvloop()
        self._started = threading.Event()
        self._shutdown = False
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)
        self.thread.start()
        self._started.wait()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.call_soon(self._started.set)
        self.loop.run_forever()

    def submit(self, coro: Awaitable) -> concurrent.futures.Future:
        """Schedule a coroutine; return a concurrent future (non-blocking)."""
        if self._shutdown:
            raise RuntimeError("BackgroundLoop is shut down")
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def run(self, coro: Awaitable, timeout: Optional[float] = None) -> Any:
        """Schedule a coroutine and block until its result.

        Refuses to run from the loop's OWN thread: ``.result()`` there
        blocks the only thread that could ever resolve the future — the
        exact self-deadlock shape of the jitted-client ``io_callback``
        hang (ROUND5 hazards; lint rule R2 catches the static shape,
        this guard retires the runtime one).  The check is one thread
        identity comparison, so it is always on, not just under
        LAH_SANITIZE."""
        if threading.current_thread() is self.thread:
            coro.close()  # never-awaited coroutine would warn at GC
            raise RuntimeError(
                f"BackgroundLoop.run() called from its own loop thread "
                f"{self.thread.name!r} — guaranteed self-deadlock (the "
                "blocked thread IS the loop that must resolve the "
                "future).  Await the coroutine instead, or hop to a "
                "host thread."
            )
        return self.submit(coro).result(timeout)

    def shutdown(self) -> None:
        """Stop the loop; pending submissions are cancelled. Idempotent."""
        if self._shutdown:
            return
        self._shutdown = True

        def _stop() -> None:
            for task in asyncio.all_tasks(self.loop):
                task.cancel()
            # cancellations are delivered on the next loop pass; stop after
            # that pass so coroutines get to run their cleanup (finally:)
            self.loop.call_soon(self.loop.stop)

        if self.loop.is_running():
            self.loop.call_soon_threadsafe(_stop)
        self.thread.join(timeout=5)
        if not self.thread.is_alive() and not self.loop.is_closed():
            self.loop.close()
