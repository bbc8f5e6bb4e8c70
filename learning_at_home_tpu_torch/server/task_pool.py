"""TaskPool: cross-request dynamic batching with static-shape bucketing.

Contract from the reference's ``hivemind/server/task_pool.py`` (SURVEY.md §2
[BJ]; unverifiable refs, mount empty): accept per-request tasks, each tied to
a future; accumulate into batches up to ``max_batch_size``; oldest-first
priority; hand formed batches to the Runtime and scatter results back.

TPU-native deltas:

- **asyncio, not processes**: tasks arrive on the server's event loop from
  connection handlers; the pool manager is a coroutine.  XLA dispatch
  releases the GIL, so process isolation buys nothing here.
- **Static shapes**: XLA compiles one program per shape.  Arbitrary batch
  sizes would recompile per request, so formed batches are padded up to a
  power-of-two row bucket (≤ ``max_batch_size``).  One compile per bucket,
  amortized forever; padding waste is tracked in :attr:`padded_rows` /
  :attr:`total_rows` and surfaces in the benchmark metrics (SURVEY.md §7
  "hard parts").
- **Off-loop stacking**: the pool manager only FORMS batches (picks tasks,
  computes row spans and the padded bucket — pure metadata).  The actual
  ``np.concatenate``-equivalent — copying task rows into a padded staging
  buffer — happens on the Runtime's device thread via :meth:`BatchJob.stack`,
  so the event loop never blocks on per-batch host memory traffic and the
  copy overlaps the previous batch's device execution.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np

from learning_at_home_tpu_torch.utils import sanitizer
from learning_at_home_tpu_torch.utils.serialization import LazyDecode

logger = logging.getLogger(__name__)


def _as_task_tensor(t):
    """Batch-formation view of a task tensor: quantized wire payloads
    (``LazyDecode``) expose shape/dtype for validation but are NOT
    materialized here — their dequantize runs on the Runtime thread,
    directly into the staging buffer (``BatchJob.stack``)."""
    return t if isinstance(t, LazyDecode) else np.asarray(t)


def bucket_rows(n: int, max_batch_size: int) -> int:
    """Smallest power-of-two ≥ n, clamped to max_batch_size (the clamp also
    covers non-power-of-two max_batch_size: 600 rows with max 1000 buckets
    to 1000, never 1024)."""
    if n >= max_batch_size:
        return max_batch_size
    return min(1 << (n - 1).bit_length(), max_batch_size) if n > 1 else 1


@dataclass(order=True)
class BatchJob:
    """One formed batch, queued for the Runtime's device thread.

    Carries the RAW per-task tensors; stacking/padding into one batch
    array happens in :meth:`stack` on the Runtime thread, never on the
    event loop.
    """

    priority: float  # oldest task's arrival time → earliest runs first
    seq: int
    pool: "TaskPool" = field(compare=False)
    task_tensors: list = field(compare=False)  # one tuple of arrays per task
    row_spans: list = field(compare=False)  # (task_future, start, stop)
    n_rows: int = field(compare=False)  # real rows before padding
    target_rows: int = field(compare=False, default=0)  # padded bucket size
    # per-input batch dtypes (np.result_type-promoted across tasks, like
    # the old np.concatenate path); None → take the first task's dtypes
    dtypes: Optional[list] = field(compare=False, default=None)
    formed_at: float = field(compare=False, default=0.0)
    # distributed-tracing ids, one per task (None for untraced requests);
    # the Runtime stamps its stage spans when the batch carries exactly
    # one distinct trace — a merged multi-trainer batch has no single
    # owner and stays unstamped
    traces: list = field(compare=False, default_factory=list)

    @sanitizer.runs_on("runtime", site="BatchJob.stack")
    def stack(self, staging) -> tuple[list, list]:
        """Copy task rows into padded staging buffers (Runtime thread).

        Returns ``(inputs, buffers)``: the stacked input arrays and the
        staging buffers to release once outputs are materialized.  A
        single task already filling its bucket passes through zero-copy
        (no buffer checked out).
        """
        if len(self.task_tensors) == 1 and self.target_rows == self.n_rows:
            # zero-copy pass-through for raw tensors; a quantized payload
            # decodes HERE (Runtime thread) — never on the event loop
            return [
                t.decode() if isinstance(t, LazyDecode) else t
                for t in self.task_tensors[0]
            ], []
        buffers: list = []
        inputs: list = []
        for i in range(len(self.task_tensors[0])):
            first = self.task_tensors[0][i]
            dtype = self.dtypes[i] if self.dtypes is not None else first.dtype
            buf = staging.acquire(
                (self.target_rows, *first.shape[1:]), dtype
            )
            buffers.append(buf)
            off = 0
            for tensors in self.task_tensors:
                part = tensors[i]
                if isinstance(part, LazyDecode):
                    # dequantize straight into the staging rows: the wire
                    # payload's only f32 materialization is the batch
                    # buffer itself
                    part.decode_into(buf[off : off + part.shape[0]])
                else:
                    buf[off : off + part.shape[0]] = part
                off += part.shape[0]
            if off < self.target_rows:
                buf[off:] = 0  # recycled buffers hold the previous batch
            inputs.append(buf)
        return inputs, buffers


@dataclass
class _Task:
    tensors: tuple
    future: asyncio.Future
    arrived: float
    n_rows: int
    trace: Optional[str] = None


class TaskPool:
    """Batches tasks for ONE expert computation (forward OR backward).

    ``process_fn(inputs) -> list[np.ndarray]`` runs on the Runtime thread.
    """

    _seq = itertools.count()

    def __init__(
        self,
        process_fn: Callable[[Sequence[np.ndarray]], Sequence[Any]],
        name: str,
        max_batch_size: int = 1024,
        batch_timeout: float = 0.002,
        pad_buckets: bool = True,
        serial_key: Optional[str] = None,
        warm_buckets: Sequence[int] | Callable[[], Sequence[int]] = (),
    ):
        self.process_fn = process_fn
        self.name = name
        self.max_batch_size = max_batch_size
        self.batch_timeout = batch_timeout
        self.pad_buckets = pad_buckets
        # jobs sharing a serial_key are never overlapped by the Runtime's
        # double buffering (forward and backward of one expert both touch
        # its params — backward DONATES them); defaults to this pool alone
        self.serial_key = serial_key if serial_key is not None else name
        self._tasks: asyncio.Queue[_Task] = asyncio.Queue()
        self._carry: Optional[_Task] = None  # oldest task that didn't fit
        self._manager_task: Optional[asyncio.Task] = None
        # padding-waste + latency telemetry (north-star metric plumbing)
        self.total_rows = 0
        self.padded_rows = 0
        self.batches_formed = 0
        # per-bucket batch counts: a bucket's FIRST batch compiles an XLA
        # program (unless AOT-warmed), the rest hit the executable cache.
        # warm_buckets may be a CALLABLE, resolved live at bucket_stats()
        # time so warmup performed after pool construction still counts
        self.bucket_batches: dict[int, int] = {}
        self.warm_buckets = warm_buckets
        self.stack_time = 0.0  # accumulated by the Runtime (its thread)

    async def submit_task(
        self, *tensors: np.ndarray, trace: Optional[str] = None
    ) -> list[np.ndarray]:
        """Submit one task (row-batch of tensors); await its outputs.
        ``trace`` (distributed tracing) rides along so the Runtime can
        stamp this batch's stage spans with the originating request."""
        n_rows = int(tensors[0].shape[0])
        if n_rows > self.max_batch_size:
            raise ValueError(
                f"task of {n_rows} rows exceeds max_batch_size="
                f"{self.max_batch_size} for pool {self.name}"
            )
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._tasks.put(
            _Task(tuple(tensors), future, time.monotonic(), n_rows, trace)
        )
        return await future

    def start(self, runtime) -> None:
        """Begin forming batches and feeding them to ``runtime``."""
        self._manager_task = asyncio.get_running_loop().create_task(
            self._manager(runtime), name=f"pool-manager-{self.name}"
        )

    def shutdown(self) -> None:
        if self._manager_task is not None:
            self._manager_task.cancel()

    async def _manager(self, runtime) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if self._carry is not None:
                first, self._carry = self._carry, None
            else:
                first = await self._tasks.get()
            batch = [first]
            rows = first.n_rows
            deadline = loop.time() + self.batch_timeout
            # Greedily absorb concurrent tasks until the bucket is full or
            # the grace window closes — this is the cross-request batching.
            while rows < self.max_batch_size:
                remaining = deadline - loop.time()
                try:
                    if remaining <= 0:
                        task = self._tasks.get_nowait()
                    else:
                        task = await asyncio.wait_for(self._tasks.get(), remaining)
                except (asyncio.TimeoutError, asyncio.QueueEmpty):
                    break
                if rows + task.n_rows > self.max_batch_size:
                    # doesn't fit: hold it as the HEAD of the next batch so
                    # oldest-first ordering survives (re-enqueueing would send
                    # it behind newer arrivals → starvation of large tasks)
                    self._carry = task
                    break
                batch.append(task)
                rows += task.n_rows
            try:
                self._dispatch(batch, rows, runtime)
            except Exception as e:
                # a malformed task (wrong arity/shape/dtype) must fail ITS
                # batch, not kill the manager — that would silently hang
                # every future request to this expert
                logger.exception("failed to form batch in pool %s", self.name)
                for t in batch:
                    if not t.future.done():
                        t.future.set_exception(
                            ValueError(f"batch formation failed: {e}")
                        )

    def _dispatch(self, batch: list[_Task], rows: int, runtime) -> None:
        """Form the job — METADATA ONLY.  No tensor bytes move here: the
        event loop must stay free to serve other connections while the
        Runtime thread does the stacking (and overlaps it with the
        previous batch's device execution)."""
        target = bucket_rows(rows, self.max_batch_size) if self.pad_buckets else rows
        # validate task compatibility up front so a malformed task fails
        # ITS batch here (old np.concatenate semantics: tail-shape or
        # arity mismatch raises; dtype differences PROMOTE via
        # np.result_type, e.g. a stray f64 task widens the batch) instead
        # of surfacing later as a runtime-side stacking error
        first = [_as_task_tensor(t) for t in batch[0].tensors]
        tasks = [tuple(first)]
        dtypes = [np.dtype(a.dtype) for a in first]
        for t in batch[1:]:
            if len(t.tensors) != len(first):
                raise ValueError(
                    f"task arity {len(t.tensors)} != batch arity {len(first)}"
                )
            coerced = []
            for i, tensor in enumerate(t.tensors):
                arr = _as_task_tensor(tensor)
                if arr.shape[1:] != first[i].shape[1:]:
                    raise ValueError(
                        f"task tensor {i} is {arr.dtype}{arr.shape}, batch "
                        f"expects (*, {first[i].shape[1:]})"
                    )
                if arr.dtype != dtypes[i]:
                    dtypes[i] = np.result_type(dtypes[i], arr.dtype)
                coerced.append(arr)
            tasks.append(tuple(coerced))
        spans, start = [], 0
        for t in batch:
            spans.append((t.future, start, start + t.n_rows))
            start += t.n_rows
        self.total_rows += rows
        self.padded_rows += target - rows
        self.batches_formed += 1
        self.bucket_batches[target] = self.bucket_batches.get(target, 0) + 1
        job = BatchJob(
            priority=batch[0].arrived,
            seq=next(self._seq),
            pool=self,
            task_tensors=tasks,
            row_spans=spans,
            n_rows=rows,
            target_rows=target,
            dtypes=dtypes,
            formed_at=time.monotonic(),
            traces=[t.trace for t in batch],
        )
        runtime.submit(job)

    # called back on the event loop by the Runtime after device execution
    def deliver(self, job: BatchJob, outputs, error: Optional[BaseException]) -> None:
        for future, start, stop in job.row_spans:
            if future.cancelled():
                continue
            if error is not None:
                future.set_exception(error)
            else:
                future.set_result([np.asarray(o[start:stop]) for o in outputs])

    @property
    def padding_waste(self) -> float:
        total = self.total_rows + self.padded_rows
        return self.padded_rows / total if total else 0.0

    def bucket_stats(self) -> dict:
        """Per-bucket batch counts with compile/hit accounting: a bucket's
        first batch pays an XLA compile (unless AOT-warmed at startup),
        every later batch hits the executable cache."""
        warm = (
            self.warm_buckets() if callable(self.warm_buckets)
            else self.warm_buckets
        )
        warm = frozenset(int(b) for b in warm)
        cold = sum(1 for b in self.bucket_batches if b not in warm)
        return {
            "batches_per_bucket": dict(sorted(self.bucket_batches.items())),
            "cold_compiles": cold,
            "cache_hits": self.batches_formed - cold,
        }
