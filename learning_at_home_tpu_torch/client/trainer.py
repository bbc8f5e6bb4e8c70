"""Pipelined swarm trainer: overlap RPC waits with local compute.

The port of ``learning_at_home_tpu/client/trainer.py``.  The sequential
swarm step serializes every MoE layer's forward fan-out, quorum wait and
backward fan-out, and the host idles during each network round trip.
The servers' experts already apply delayed updates on every backward
RPC, so the trainer can be asynchronous too: ``n_workers`` Python threads
each run an eager train step of ``SwarmDMoETransformerLM`` on their own
micro-batch, and trunk and gate updates apply as each finishes.

Mechanics: each worker computes its gradients against the params
snapshot taken at its step's start (the model's steps build a NEW params
tree, so a snapshot is never written under a worker); the torch trunk
and the MoE dispatch's quorum wait release the GIL, so one step waits on
expert replies while another computes.  A lock serializes only the
optimizer apply; updates may be ``n_workers - 1`` steps stale (bounded
staleness, the same class as the servers' async SGD).  ``n_workers=1``
reproduces the sequential steps exactly.

Multi-trainer synchronization: in async-DP runs each trainer owns its own
trunk/gate state.  :meth:`attach_averaging` plugs in an
``averaging.AveragingSession`` — between local steps the session
snapshots the params (a consistent read under the apply lock), runs a
DHT-matched group all-reduce with the other trainers (of either package)
in the background, and applies the group delta atomically (``params +=
mean - snapshot``; local steps taken during the round survive).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional

from learning_at_home_tpu_torch.optim import applied_updates, value_and_grad
from learning_at_home_tpu_torch.utils import sanitizer

__all__ = ["PipelinedSwarmTrainer"]


class PipelinedSwarmTrainer:
    """Runs concurrent micro-batch train steps against a swarm model.

    Usage::

        trainer = PipelinedSwarmTrainer(model, optimizer, params, n_workers=4)
        result = trainer.train(batches, steps=100, on_log=print)
        params = trainer.params
    """

    def __init__(
        self,
        model: Any,  # SwarmDMoETransformerLM-shaped: loss_fn(params, ids, tgt)
        optimizer: Any,  # an optim.GradientTransformation
        params: Any,
        opt_state: Any = None,
        n_workers: int = 2,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.model = model
        self.optimizer = optimizer
        self.params = params
        self.opt_state = opt_state if opt_state is not None else optimizer.init(params)
        self.n_workers = n_workers
        self._apply_lock = sanitizer.lock("trainer.apply")
        self._batch_lock = sanitizer.lock("trainer.batch")
        self._grad_fn = value_and_grad(model.loss_fn)
        self.losses: list[float] = []
        self.step_count = 0
        self.errors: list[BaseException] = []
        self._averaging = None  # AveragingSession via attach_averaging

    # ---- internals ----

    def _next_batch(self, it: Iterator, budget: list[int]):
        """Thread-safe batch claim; returns (step_idx, batch) or None."""
        with self._batch_lock:
            if budget[0] <= 0:
                return None
            budget[0] -= 1
            try:
                batch = next(it)
            except StopIteration:
                budget[0] = 0
                return None
            return self.step_count, batch

    def _worker(self, it, budget, on_step: Optional[Callable]):
        while True:
            try:
                claim = self._next_batch(it, budget)
            except BaseException as e:  # iterator failure must not be silent
                self.errors.append(e)
                with self._batch_lock:
                    budget[0] = 0
                return
            if claim is None:
                return
            _, (ids, tgt) = claim
            params_snapshot = self.params  # delayed-update read
            try:
                loss, grads = self._grad_fn(params_snapshot, ids, tgt)
            except BaseException as e:  # surface, don't strand the budget
                self.errors.append(e)
                with self._batch_lock:
                    budget[0] = 0
                return
            with self._apply_lock:
                updates, self.opt_state = self.optimizer.update(
                    grads, self.opt_state, self.params
                )
                self.params = applied_updates(self.params, updates)
                self.step_count += 1
                self.losses.append(float(loss))
                step_now = self.step_count
            if on_step is not None:
                on_step(step_now, float(loss))
            if self._averaging is not None:
                self._averaging.notify_step(step_now)

    # ---- public API ----

    def attach_averaging(self, session) -> None:
        """Plug in an ``averaging.AveragingSession``: it snapshots params
        between steps and applies the group mean atomically."""
        session.attach_trainer(
            snapshot_fn=lambda: self.snapshot()[0],
            apply_fn=self.apply_param_transform,
        )
        self._averaging = session

    def apply_param_transform(self, transform) -> None:
        """Atomically replace ``params`` with ``transform(params)`` under
        the apply lock (the averaging-apply entry point — never races an
        optimizer update)."""
        with self._apply_lock:
            self.params = transform(self.params)

    def averaging_stats(self) -> dict | None:
        return (
            self._averaging.averaging_stats()
            if self._averaging is not None else None
        )

    def snapshot(self) -> tuple:
        """A CONSISTENT (params, opt_state, step_count) triple — the three
        are only mutated together under the apply lock, so checkpointing
        callers must read them under it too."""
        with self._apply_lock:
            return self.params, self.opt_state, self.step_count

    def train(
        self,
        batches: Iterable,
        steps: int,
        log_every: int = 10,
        on_log: Optional[Callable[[dict], None]] = None,
        tokens_per_batch: Optional[int] = None,
    ) -> dict:
        """Consume ``steps`` micro-batches with ``n_workers`` concurrent
        steps in flight; returns a summary dict (losses, tokens/sec)."""
        it = iter(batches)
        budget = [steps]
        t0 = time.perf_counter()

        def on_step(step_now: int, loss: float) -> None:
            if on_log is not None and (
                step_now % log_every == 0 or step_now == steps
            ):
                elapsed = time.perf_counter() - t0
                entry = {
                    "step": step_now,
                    "loss": round(loss, 4),
                    "steps_per_sec": round(step_now / elapsed, 2),
                }
                if tokens_per_batch:
                    entry["tokens_per_sec"] = round(
                        step_now * tokens_per_batch / elapsed, 1
                    )
                on_log(entry)

        threads = [
            threading.Thread(
                target=self._worker, args=(it, budget, on_step),
                name=f"swarm-trainer-{i}", daemon=True,
            )
            for i in range(self.n_workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.errors:
            raise self.errors[0]
        elapsed = time.perf_counter() - t0
        return {
            "steps": self.step_count,
            "elapsed_s": elapsed,
            "final_loss": self.losses[-1] if self.losses else None,
            "mean_loss_last_10": (
                sum(self.losses[-10:]) / len(self.losses[-10:])
                if self.losses
                else None
            ),
            "tokens_per_sec": (
                self.step_count * tokens_per_batch / elapsed
                if tokens_per_batch
                else None
            ),
        }
