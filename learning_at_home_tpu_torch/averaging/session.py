"""AveragingSession: wires a DecentralizedAverager into a training loop.

The port of ``learning_at_home_tpu/averaging/session.py``; trees are the
port's (tensors on the trainer's device), the delta applied with
``tree.tree_map``.

Two usage modes, matching the two trainer shapes in this repo:

- **blocking** (the sequential ``train_lm`` loop): the loop calls
  :meth:`blocking_round` between steps; the returned tree REPLACES the
  params, so after any successful round all participants hold identical
  trunk/gate parameters (the convergence contract the smoke test
  asserts).  Matchmaking failures are tolerated and counted — a lone
  trainer keeps training.
- **background** (``PipelinedSwarmTrainer``): the trainer notifies the
  session per optimizer step; every ``every_steps`` the session thread
  snapshots the params (a consistent read under the trainer's apply
  lock), runs a round while local steps continue, then applies the
  group DELTA atomically: ``params += group_mean - snapshot``.  Local
  progress made during the round survives — delayed updates, the same
  staleness class as the rest of the paper's async design.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Optional

from learning_at_home_tpu_torch.tree import tree_map
from learning_at_home_tpu_torch.utils import sanitizer
from learning_at_home_tpu_torch.averaging.averager import (
    AveragingFailed,
    DecentralizedAverager,
)

logger = logging.getLogger(__name__)


class AveragingSession:
    """Periodic parameter averaging around a trainer's param pytree."""

    def __init__(
        self,
        averager: DecentralizedAverager,
        every_steps: int = 10,
    ):
        if every_steps < 1:
            raise ValueError("every_steps must be >= 1")
        self.averager = averager
        self.every_steps = every_steps
        self.rounds_applied = 0
        self.rounds_failed = 0
        self._lock = sanitizer.lock("averaging.session")
        self._round_in_flight = False
        # background mode wiring (attach_trainer)
        self._snapshot_fn: Optional[Callable[[], Any]] = None
        self._apply_fn: Optional[Callable[[Callable], None]] = None
        self._last_round_step = 0

    # ---- blocking mode (sequential loops) ----

    def blocking_round(
        self, tree: Any, matchmaking_timeout: Optional[float] = None
    ) -> Any:
        """One synchronous round; returns the group mean, or the input
        tree unchanged when no group formed (failure is counted, never
        raised — averaging must not kill a training loop)."""
        try:
            averaged, _info = self.averager.step_round(
                tree, matchmaking_timeout=matchmaking_timeout
            )
        except AveragingFailed as e:
            with self._lock:
                self.rounds_failed += 1
            logger.warning("averaging round skipped: %s", e)
            return tree
        with self._lock:
            self.rounds_applied += 1
        return averaged

    # ---- background mode (PipelinedSwarmTrainer) ----

    def attach_trainer(
        self,
        snapshot_fn: Callable[[], Any],
        apply_fn: Callable[[Callable], None],
    ) -> None:
        """``snapshot_fn()`` must return a CONSISTENT params pytree;
        ``apply_fn(transform)`` must run ``params = transform(params)``
        atomically with respect to optimizer applies."""
        self._snapshot_fn = snapshot_fn
        self._apply_fn = apply_fn

    def notify_step(self, step_count: int) -> None:
        """Called by the trainer after each optimizer apply; kicks a
        background round every ``every_steps`` steps (at most one in
        flight — a slow round never queues a backlog)."""
        if self._snapshot_fn is None:
            return
        with self._lock:
            due = (
                step_count - self._last_round_step >= self.every_steps
                and not self._round_in_flight
            )
            if due:
                self._round_in_flight = True
                self._last_round_step = step_count
        if due:
            threading.Thread(
                target=self._background_round, name="lah-avg-round",
                daemon=True,
            ).start()

    def _background_round(self) -> None:
        try:
            snapshot = self._snapshot_fn()
            try:
                averaged, _info = self.averager.step_round(snapshot)
            except AveragingFailed as e:
                with self._lock:
                    self.rounds_failed += 1
                logger.warning("background averaging round skipped: %s", e)
                return
            def apply_delta(current):
                # delayed-update tolerant: steps taken while the round
                # ran survive; only the group correction is added (on
                # the trainer's device: the averaged leaves came back on
                # the snapshot's)
                return tree_map(
                    lambda cur, avg, snap: cur + (avg - snap),
                    current, averaged, snapshot,
                )

            self._apply_fn(apply_delta)
            with self._lock:
                self.rounds_applied += 1
        except Exception:
            with self._lock:
                self.rounds_failed += 1
            logger.exception("background averaging round crashed")
        finally:
            with self._lock:
                self._round_in_flight = False

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Block until no background round is in flight (pre-final-round
        barrier; True on idle, False on timeout)."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._round_in_flight:
                    return True
            time.sleep(0.05)
        return False

    # ---- telemetry ----

    def averaging_stats(self) -> dict:
        stats = self.averager.stats()
        with self._lock:
            stats["rounds_applied"] = self.rounds_applied
            stats["rounds_skipped"] = self.rounds_failed
        return stats

    def shutdown(self) -> None:
        self.wait_idle(timeout=10.0)
        self.averager.shutdown()
