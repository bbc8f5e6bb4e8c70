"""Runtime: the double-buffered device-consumer loop executing formed batches.

The port's copy of the JAX package's ``server/runtime.py``.  Contract from
the reference's ``hivemind/server/runtime.py`` (SURVEY.md §2 [BJ]):
repeatedly pick the **highest-priority (oldest-waiting) non-empty pool**
across all experts, run its batch on the device, push outputs back to the
pool's futures.  A single serialized consumer per device → no
intra-device contention and per-expert update serialization for free.

A dedicated Python thread per process drains a thread-safe priority
queue of :class:`BatchJob`s.  Torch releases the GIL inside its kernels
and CUDA launches return at once, so the asyncio networking loop keeps
serving while the card computes.  Results are handed back to the event
loop via ``call_soon_threadsafe``.

The loop is **double-buffered** on CUDA's asynchronous launches: the
backend returns output tensors whose kernels may still be running; while
job N's outputs come to the host (``.cpu()``, which waits for them), job
N+1 has already been stacked — into reusable staging buffers from
:mod:`.staging` — and launched, so host work (stacking, output copies,
future delivery) overlaps device execution instead of serializing with
it.  A staging buffer is released only after its job's outputs reached
the host, which is after the job's host→card copies, earlier in the same
stream, completed.  The one hard exception: two jobs sharing a pool
``serial_key`` (forward/backward of the SAME expert — backward rewrites
the params forward reads) are never in flight together.
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from learning_at_home_tpu_torch.convert import tensor_to_numpy
from learning_at_home_tpu_torch.server.staging import StagingBuffers
from learning_at_home_tpu_torch.server.task_pool import BatchJob
from learning_at_home_tpu_torch.utils.profiling import timeline

logger = logging.getLogger(__name__)

# Sentinel must be a tuple so it compares cleanly inside the PriorityQueue;
# -inf priority drains it ahead of any real job.
_SENTINEL = (float("-inf"), -1, None)


def _job_trace(job: BatchJob) -> Optional[str]:
    """The batch's trace id for span stamping: the single distinct
    non-None task trace, or None when the batch merged several traced
    requests (no single owner) or carried none."""
    distinct = {t for t in getattr(job, "traces", ()) if t}
    return distinct.pop() if len(distinct) == 1 else None


@dataclass
class _Inflight:
    """A dispatched-but-not-materialized job (the second pipeline stage)."""

    job: BatchJob
    raw_outputs: list
    staging: list = field(default_factory=list)
    started: float = 0.0
    dispatch_s: float = 0.0  # duration of the process_fn call itself
    trace: Optional[str] = None  # distributed-tracing id (see _job_trace)


class Runtime:
    """Double-buffered device executor fed by all TaskPools of a Server."""

    def __init__(self, loop: Optional[asyncio.AbstractEventLoop] = None):
        self._queue: queue.PriorityQueue = queue.PriorityQueue()
        self._loop = loop
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.staging = StagingBuffers()
        # telemetry (written by the runtime thread; read anywhere)
        self.jobs_processed = 0
        self.jobs_overlapped = 0  # dispatched while another job was in flight
        self.device_time = 0.0  # process_fn + materialization (busy time)
        self.queue_time = 0.0
        self.stack_time = 0.0
        self.materialize_time = 0.0
        self.queue_depth_max = 0

    def attach_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop

    def start(self) -> None:
        assert self._loop is not None, "attach_loop() before start()"
        self._thread = threading.Thread(
            target=self._run, name="lah-runtime", daemon=True
        )
        self._thread.start()

    def submit(self, job: BatchJob) -> None:
        """Called from the event loop when a pool has formed a batch."""
        self._queue.put((job.priority, job.seq, job))
        depth = self._queue.qsize()
        if depth > self.queue_depth_max:
            self.queue_depth_max = depth

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    def _run(self) -> None:
        pending: Optional[_Inflight] = None
        while True:
            if pending is None:
                item = self._queue.get()
            else:
                try:
                    # don't wait: if no new job is ready, spend the idle
                    # time materializing the in-flight one instead
                    item = self._queue.get_nowait()
                except queue.Empty:
                    self._finish(pending)
                    pending = None
                    continue
            _, _, job = item
            if job is None or self._stop.is_set():
                if pending is not None:
                    self._finish(pending)
                    pending = None
                if job is not None:
                    self._deliver(job, None, RuntimeError("runtime shut down"))
                break
            if (
                pending is not None
                and pending.job.pool.serial_key == job.pool.serial_key
            ):
                # per-expert serialization: never overlap two jobs of the
                # same expert/pool — drain the pipeline first
                self._finish(pending)
                pending = None
            overlapped = pending is not None
            inflight = self._dispatch_job(job)
            if pending is not None:
                self._finish(pending)
                pending = None
            if inflight is not None and overlapped:
                self.jobs_overlapped += 1
                timeline.count("runtime.jobs_overlapped")
            pending = inflight
        if pending is not None:
            self._finish(pending)
        self._drain_remaining()

    def _dispatch_job(self, job: BatchJob) -> Optional[_Inflight]:
        """Stage one: stack the batch into staging buffers and dispatch the
        jitted call.  Returns the in-flight record, or None if the job
        failed (error already delivered)."""
        started = time.monotonic()
        self.queue_time += started - job.formed_at
        buffers: list = []
        trace = _job_trace(job)
        try:
            with timeline.span(f"runtime.stack.{job.pool.name}", trace=trace):
                inputs, buffers = job.stack(self.staging)
            stacked = time.monotonic()
            self.stack_time += stacked - started
            job.pool.stack_time += stacked - started
            with timeline.span(
                f"runtime.dispatch.{job.pool.name}", trace=trace
            ):
                raw = list(job.pool.process_fn(inputs))
            dispatched = time.monotonic()
        except BaseException as e:  # deliver, don't kill the device loop
            logger.exception("runtime job failed in pool %s", job.pool.name)
            self.staging.release(buffers)
            self.jobs_processed += 1
            self._deliver(job, None, e)
            return None
        return _Inflight(
            job, raw, buffers, started, dispatched - stacked, trace
        )

    def _finish(self, inflight: _Inflight) -> None:
        """Stage two: materialize the outputs (blocks until the device
        finishes — this is the wait the NEXT job's dispatch overlaps),
        recycle the staging buffers, deliver to the pool's futures."""
        job = inflight.job
        outputs, error = None, None
        t0 = time.monotonic()
        try:
            with timeline.span(
                f"runtime.materialize.{job.pool.name}", trace=inflight.trace
            ):
                outputs = []
                for o in inflight.raw_outputs:
                    # a card tensor comes to the host here: ``.cpu()``
                    # waits for the kernels that produce it
                    arr = (tensor_to_numpy(o) if isinstance(o, torch.Tensor)
                           else np.asarray(o))
                    # a pure-host process_fn (or a CPU backend) can return
                    # views INTO the staging buffers; those must be copied
                    # out before the buffer is recycled under the results
                    if inflight.staging and any(
                        np.may_share_memory(arr, buf)
                        for buf in inflight.staging
                    ):
                        arr = np.array(arr)
                    outputs.append(arr)
        except BaseException as e:
            logger.exception(
                "runtime job failed to materialize in pool %s", job.pool.name
            )
            error = e
        now = time.monotonic()
        self.materialize_time += now - t0
        # device_time keeps its pre-pipeline meaning — process_fn call +
        # output materialization, the job's own busy time.  Under overlap,
        # wall time from dispatch to materialized also contains the NEXT
        # job's stack/dispatch; folding that in would double-count and
        # make the pipelined runtime read as a device-time regression.
        busy = inflight.dispatch_s + (now - t0)
        self.device_time += busy
        self.jobs_processed += 1
        timeline.record(
            f"runtime.{job.pool.name}", inflight.started, busy,
            trace=inflight.trace,
        )
        self.staging.release(inflight.staging)
        self._deliver(job, outputs, error)

    def stats(self) -> dict:
        """Hot-path telemetry snapshot for the server ``stats`` surface."""
        jobs = self.jobs_processed
        return {
            "jobs_processed": jobs,
            "jobs_overlapped": self.jobs_overlapped,
            "overlap_fraction": round(self.jobs_overlapped / jobs, 4) if jobs else 0.0,
            "device_time_ms": round(self.device_time * 1e3, 2),
            "queue_time_ms": round(self.queue_time * 1e3, 2),
            "stack_time_ms": round(self.stack_time * 1e3, 2),
            "materialize_time_ms": round(self.materialize_time * 1e3, 2),
            "queue_depth": self.queue_depth,
            "queue_depth_max": self.queue_depth_max,
            "staging": self.staging.stats(),
        }

    def _deliver(self, job: BatchJob, outputs, error) -> None:
        try:
            self._loop.call_soon_threadsafe(job.pool.deliver, job, outputs, error)
        except RuntimeError:
            pass  # event loop already closed; the futures died with it

    def _drain_remaining(self) -> None:
        """Fail queued-but-never-run jobs fast instead of leaving their
        clients to hit the full RPC timeout."""
        while True:
            try:
                _, _, job = self._queue.get_nowait()
            except queue.Empty:
                return
            if job is not None:
                self._deliver(job, None, RuntimeError("runtime shut down"))

    def shutdown(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._queue.put(_SENTINEL)
        if self._thread is not None:
            self._thread.join(timeout=timeout)
