"""Reusable host staging buffers for off-loop batch stacking.

Batch stacking used to run on the asyncio networking loop
(``TaskPool._dispatch``: ``np.concatenate`` + zero-pad per batch, blocking
every connection while host memory churned).  It now runs on the Runtime's
device thread, copying task rows into **preallocated per-bucket buffers**
drawn from this pool — steady-state serving allocates nothing per batch.

Lifecycle contract (enforced by the Runtime, tested in
``tests/test_task_pool_runtime.py``):

- a buffer is checked out for exactly one :class:`BatchJob` and is NOT
  returned until that job's outputs are materialized — two in-flight
  batches of the same bucket never share a buffer, even across pools;
- padding rows are re-zeroed on every checkout (a recycled buffer holds
  the previous batch's rows);
- outputs that alias a staging buffer (a pure-numpy ``process_fn``
  returning its input) are copied before the buffer is recycled.
"""

from __future__ import annotations

import threading

import numpy as np

from learning_at_home_tpu_torch.utils import sanitizer

# keep at most this many idle buffers per (shape, dtype) key: double
# buffering needs 2; a small surplus absorbs pool churn without letting
# a one-off giant bucket pin host memory forever
MAX_FREE_PER_KEY = 4


class StagingBuffers:
    """Free-lists of host arrays keyed by (shape, dtype), with telemetry.

    Thread-safe, though in practice acquire/release both run on the one
    Runtime thread.  ``allocated`` counts fresh ``np.empty`` calls;
    ``reused`` counts checkouts served from the free list — their ratio is
    the steady-state reuse fraction surfaced in server stats.
    """

    def __init__(self, max_free_per_key: int = MAX_FREE_PER_KEY):
        self.max_free_per_key = max_free_per_key
        self._free: dict[tuple, list[np.ndarray]] = {}
        self._lock = sanitizer.lock("server.staging")
        self.allocated = 0
        self.reused = 0

    @staticmethod
    def _key(shape: tuple, dtype) -> tuple:
        return (tuple(int(d) for d in shape), np.dtype(dtype).str)

    def acquire(self, shape: tuple, dtype) -> np.ndarray:
        """Check out one buffer of exactly ``shape``/``dtype`` (contents
        undefined — the caller overwrites real rows and zeroes the pad)."""
        key = self._key(shape, dtype)
        with self._lock:
            free = self._free.get(key)
            if free:
                self.reused += 1
                return free.pop()
            self.allocated += 1
        return np.empty(shape, dtype)

    def release(self, buffers) -> None:
        """Return checked-out buffers to their free lists."""
        for buf in buffers:
            key = self._key(buf.shape, buf.dtype)
            with self._lock:
                free = self._free.setdefault(key, [])
                if len(free) < self.max_free_per_key:
                    free.append(buf)

    def stats(self) -> dict:
        with self._lock:
            total = self.allocated + self.reused
            return {
                "allocated": self.allocated,
                "reused": self.reused,
                "reuse_fraction": round(self.reused / total, 4) if total else 0.0,
                "idle_buffers": sum(len(v) for v in self._free.values()),
            }
