"""A group of rank processes on one host that run functions sent to them.

``RankGroup(n, backend)`` spawns ``n`` processes of this
interpreter, joins them into one ``torch.distributed`` job over TCP on
localhost (``multihost.initialize_multihost``) and keeps them for reuse: ``group.run(fn, *args)`` calls ``fn(*args)`` on
every rank and returns the ranks' results in rank order;
``group.run_each(fn, [args_0, ...])`` gives each rank its own arguments.
``fn`` is pickled by reference, so it is a module-level function of a
module the ranks can import.  A rank that raises fails the call with its
traceback, reported as soon as it comes (its peers may be left waiting in
a collective); a call that outlasts its timeout kills the group (a rank
stuck in a collective cannot be interrupted) and raises ``TimeoutError``,
each rank having written its threads' stacks to stderr shortly before.

It serves the CPU tests (``gloo`` ranks on the CPU) and ``chip_smoke.py``
(``gloo`` ranks sharing one card, ``nccl`` ranks one card each).
"""

from __future__ import annotations

import faulthandler
import multiprocessing
import multiprocessing.connection
import os
import socket
import time
import traceback

DEFAULT_CALL_TIMEOUT_S = 300.0
# after a rank's error, how long the others' answers are waited for
ERROR_GRACE_S = 10.0
# how long before a call's timeout each rank dumps its threads' stacks
STACKS_BEFORE_S = 15.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, timeout_s, threads, env, conn):
    os.environ.update(env)
    import torch

    torch.set_num_threads(threads)
    from learning_at_home_tpu_torch.parallel.multihost import (
        initialize_multihost,
    )

    try:
        initialize_multihost(f"127.0.0.1:{port}", world, rank,
                             backend=backend, timeout_s=timeout_s)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        return
    conn.send(("ok", None))
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        if msg is None:
            break
        fn, args, kwargs, stacks_after_s = msg
        # a call that hangs shows where, before the group is killed
        faulthandler.dump_traceback_later(stacks_after_s, exit=False)
        try:
            out = fn(*args, **kwargs)
        except BaseException:
            conn.send(("error", traceback.format_exc()))
        else:
            conn.send(("ok", out))
        finally:
            faulthandler.cancel_dump_traceback_later()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class RankGroup:
    """``world_size`` rank processes joined by ``backend`` (see the module
    docstring).  ``env`` is added to each rank's environment (``LOCAL_RANK``
    is the rank unless ``env`` sets it); ``timeout_s`` bounds every
    collective inside the ranks and every call from here.  With
    ``wait=False`` the constructor returns while the ranks start (their
    imports and rendezvous overlap the caller's work) and the first call
    waits for them."""

    def __init__(self, world_size: int, backend: str = "gloo",
                 timeout_s: float = DEFAULT_CALL_TIMEOUT_S,
                 threads: int = 1, env: dict | None = None,
                 wait: bool = True):
        self.world_size = world_size
        self.timeout_s = timeout_s
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self._procs, self._conns = [], []
        for rank in range(world_size):
            parent, child = ctx.Pipe()
            rank_env = {"LOCAL_RANK": str(rank), **(env or {})}
            proc = ctx.Process(
                target=_rank_main, daemon=True,
                args=(rank, world_size, port, backend, timeout_s, threads,
                      rank_env, child))
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)
        self._started = False
        if wait:
            self._start()

    def _start(self) -> None:
        if not self._started:
            self._gather(self.timeout_s, "start")
            self._started = True

    def _gather(self, timeout_s: float, what: str) -> list:
        """Every rank's answer, in rank order.  The first error ends the
        wait after ERROR_GRACE_S more for the others' answers; then the
        ranks that gave none are killed with the group."""
        deadline = time.monotonic() + timeout_s
        results = [None] * self.world_size
        errors = []
        waiting = dict(enumerate(self._conns))
        while waiting:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            for conn in multiprocessing.connection.wait(
                    list(waiting.values()), timeout=left):
                rank = next(r for r, c in waiting.items() if c is conn)
                del waiting[rank]
                try:
                    status, value = conn.recv()
                except EOFError:
                    status, value = "error", "the rank's process exited"
                if status == "ok":
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    deadline = min(deadline,
                                   time.monotonic() + ERROR_GRACE_S)
        if waiting or errors:
            self.close(kill=True)
        if errors:
            raise RuntimeError(
                f"{what} failed on {len(errors)} rank(s) (no answer from "
                f"{sorted(waiting)}):\n" + "\n".join(errors))
        if waiting:
            raise TimeoutError(f"ranks {sorted(waiting)} gave no answer to "
                               f"{what} within {timeout_s} s")
        return results

    def run_each(self, fn, per_rank_args, timeout_s: float | None = None,
                 **kwargs) -> list:
        """``fn(*per_rank_args[r], **kwargs)`` on each rank ``r``; the
        results in rank order."""
        if len(per_rank_args) != self.world_size:
            raise ValueError(f"{len(per_rank_args)} argument tuples for "
                             f"{self.world_size} ranks")
        self._start()
        timeout_s = timeout_s or self.timeout_s
        for conn, args in zip(self._conns, per_rank_args):
            conn.send((fn, tuple(args), kwargs,
                       max(timeout_s - STACKS_BEFORE_S, 1.0)))
        return self._gather(timeout_s, getattr(fn, "__name__", repr(fn)))

    def run(self, fn, *args, timeout_s: float | None = None, **kwargs
            ) -> list:
        """``fn(*args, **kwargs)`` on every rank; the results in rank
        order."""
        return self.run_each(fn, [args] * self.world_size, timeout_s,
                             **kwargs)

    def close(self, kill: bool = False) -> None:
        """Stops every rank (at once with ``kill``)."""
        for conn in self._conns:
            if not kill:
                try:
                    conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for proc in self._procs:
            if not kill:
                proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=30)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)
