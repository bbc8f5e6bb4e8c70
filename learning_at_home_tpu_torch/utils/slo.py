"""Declarative SLO engine (ISSUE 19 layer 3).

One evaluator, two spec shapes:

- :class:`Threshold` + :func:`evaluate_thresholds` — point-in-time
  floors/ceilings over a report dict.  The rebalancer's SLO gate, the
  load generator's floors and the macro-sim ``--check`` ceilings are all
  re-expressed as lists of these (their numeric thresholds unchanged),
  so "is this report healthy" has exactly one comparison engine.

- :class:`BurnRateSLO` + :class:`SLOEvaluator` — Google-SRE-style
  multiwindow burn-rate alerting over cumulative good/bad event
  counters.  A source callback returns ``(good_total, bad_total)``; the
  evaluator keeps a bounded ring of timestamped samples, computes the
  bad-fraction over a fast and a slow window, and divides by the error
  budget (``1 - objective``) to get burn rates.  PAGE requires BOTH
  windows to burn past the page threshold (fast-only spikes don't page,
  long-slow burns do); WARN fires on the slow window alone.  State
  transitions land in the flight recorder, and entering PAGE dumps a
  flight artifact — the page IS the postmortem trigger.

Evaluation happens at metrics-scrape time: components register the
evaluator's :meth:`~SLOEvaluator.collect` as a registry collector, so
the work runs on the ``lah-metrics`` loop and exports ``lah_slo_*``
series with zero hot-path cost.  The module clock seam ``_monotonic``
is virtual-clock patchable like every other time read.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional, Sequence

from learning_at_home_tpu_torch.utils import flight, sanitizer

_monotonic = time.monotonic  # clock seam (tests / sim patch this)

OK, WARN, PAGE = "ok", "warn", "page"
STATE_VALUE = {OK: 0.0, WARN: 1.0, PAGE: 2.0}

_OPS: dict[str, Callable[[float, float], bool]] = {
    "<=": lambda v, b: v <= b,
    ">=": lambda v, b: v >= b,
    "<": lambda v, b: v < b,
    ">": lambda v, b: v > b,
    "==": lambda v, b: v == b,
}


# --------------------------------------------------------------------------
# threshold specs (floors / ceilings over a report dict)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Threshold:
    """``lookup(report, metric) <op> bound`` must hold, else violation."""

    name: str  # human-facing spec name ("ttft_p99_ceiling")
    metric: str  # dotted path into the report ("serving.ttft_p99_ms")
    op: str  # one of <=, >=, <, >, ==
    bound: float

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown threshold op {self.op!r}")


def lookup(report: dict, path: str):
    """Dotted-path read; None when any hop is missing/non-dict."""
    cur = report
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def evaluate_thresholds(
    report: dict, specs: Iterable[Threshold]
) -> list[dict]:
    """Return one violation dict per failed spec (empty == healthy).

    A missing or non-numeric metric IS a violation — a gate that cannot
    read its signal must fail closed, not pass silently."""
    violations: list[dict] = []
    for spec in specs:
        raw = lookup(report, spec.metric)
        try:
            value = float(raw)  # type: ignore[arg-type]
        except (TypeError, ValueError):
            violations.append(
                {
                    "slo": spec.name, "metric": spec.metric, "value": None,
                    "op": spec.op, "bound": spec.bound,
                    "detail": f"{spec.metric} missing or non-numeric",
                }
            )
            continue
        if not _OPS[spec.op](value, spec.bound):
            violations.append(
                {
                    "slo": spec.name, "metric": spec.metric, "value": value,
                    "op": spec.op, "bound": spec.bound,
                    "detail": (
                        f"{spec.metric}={value:g} violates "
                        f"{spec.op} {spec.bound:g}"
                    ),
                }
            )
    return violations


# --------------------------------------------------------------------------
# burn-rate SLOs (cumulative good/bad counters → OK/WARN/PAGE)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BurnRateSLO:
    """Objective + windows for one event-ratio SLO."""

    name: str  # metric-legal: lands in lah_slo_<name>_* series
    objective: float  # target good fraction, e.g. 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    page_burn: float = 14.0  # burn-rate multiple that pages (both windows)
    warn_burn: float = 3.0  # slow-window burn that warns
    description: str = ""

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast window must not exceed slow window")


class SLOEvaluator:
    """Evaluates registered burn-rate SLOs from cumulative counters.

    ``source`` is ``fn() -> (good_total, bad_total)`` — monotonically
    non-decreasing counters, read at evaluation time (scrape)."""

    _MAX_SAMPLES = 512  # ring bound per SLO

    def __init__(self, component: str = "slo"):
        self.component = component
        self._lock = sanitizer.lock("slo.evaluator")
        # name -> (slo, source, ring[(t, good, bad)], state)
        self._entries: dict[str, list] = {}

    def register(
        self, slo: BurnRateSLO,
        source: Callable[[], tuple[float, float]],
    ) -> None:
        try:
            good, bad = source()
        except Exception:
            good, bad = 0.0, 0.0
        with self._lock:
            self._entries[slo.name] = [
                slo, source, [(_monotonic(), float(good), float(bad))], OK,
            ]

    def _window_burn(
        self, slo: BurnRateSLO, ring: list, now: float, window: float,
        good: float, bad: float,
    ) -> float:
        """Burn rate over ``window``: bad fraction / error budget."""
        base = ring[0]
        for sample in ring:
            if sample[0] <= now - window:
                base = sample
            else:
                break
        good_d = good - base[1]
        bad_d = bad - base[2]
        total = good_d + bad_d
        if total <= 0:
            return 0.0
        return (bad_d / total) / (1.0 - slo.objective)

    def evaluate(self, now: Optional[float] = None) -> dict[str, dict]:
        """Sample every source, update rings, return per-SLO status."""
        if now is None:
            now = _monotonic()
        with self._lock:
            entries = list(self._entries.items())
        out: dict[str, dict] = {}
        for name, entry in entries:
            slo, source, ring, prev_state = entry
            try:
                good, bad = source()
            except Exception:
                continue
            good, bad = float(good), float(bad)
            with self._lock:
                ring.append((now, good, bad))
                # prune: keep the newest pre-window sample as the base
                horizon = now - slo.slow_window_s
                while len(ring) > 2 and ring[1][0] <= horizon:
                    ring.pop(0)
                if len(ring) > self._MAX_SAMPLES:
                    del ring[1:2]
                fast = self._window_burn(
                    slo, ring, now, slo.fast_window_s, good, bad
                )
                slow = self._window_burn(
                    slo, ring, now, slo.slow_window_s, good, bad
                )
                if fast >= slo.page_burn and slow >= slo.page_burn:
                    state = PAGE
                elif slow >= slo.warn_burn:
                    state = WARN
                else:
                    state = OK
                entry[3] = state
            if state != prev_state:
                flight.record(
                    self.component, "slo_state_change", slo=name,
                    state=state, prev=prev_state,
                    fast_burn=round(fast, 3), slow_burn=round(slow, 3),
                )
                if state == PAGE:
                    flight.dump(f"slo_page_{name}")
            out[name] = {
                "state": state, "fast_burn": fast, "slow_burn": slow,
                "good_total": good, "bad_total": bad,
                "objective": slo.objective,
            }
        return out

    def collect(self) -> dict[str, float]:
        """Registry-collector form: flat ``lah_slo_*`` series.  The
        worst-across-collectors MAX merge rule is exactly right for the
        state series (any paging instance pages the fleet view)."""
        out: dict[str, float] = {}
        for name, st in self.evaluate().items():
            out[f"lah_slo_{name}_state"] = STATE_VALUE[st["state"]]
            out[f"lah_slo_{name}_fast_burn"] = st["fast_burn"]
            out[f"lah_slo_{name}_slow_burn"] = st["slow_burn"]
            out[f"lah_slo_{name}_objective"] = st["objective"]
            out[f"lah_slo_{name}_bad_events_total"] = st["bad_total"]
            out[f"lah_slo_{name}_good_events_total"] = st["good_total"]
        return out

    def states(self) -> dict[str, str]:
        with self._lock:
            return {name: e[3] for name, e in self._entries.items()}
