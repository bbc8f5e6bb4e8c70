"""Mergeable quantile sketches + the one shared percentile helper (ISSUE 19).

Two things live here, both dependency-free (``math`` only — the macro-sim
imports this module and must stay numpy-free for byte-determinism):

- :func:`percentile` — THE percentile definition for every number this
  repo reports.  ``method="linear"`` replicates ``np.percentile``'s
  default linear interpolation bit-for-bit (same virtual-index formula,
  same two-sided lerp), so experiments/loadgen.py and bench.py keep
  emitting byte-identical values after switching off numpy;
  ``method="nearest"`` replicates the macro-sim's pure-Python
  nearest-rank formula (``sim/runner.py``) including Python banker's
  rounding.  One definition, three former private copies — the parity is
  pinned by tests/test_sketch.py.

- :class:`QuantileSketch` — a DDSketch-style log-bucketed quantile
  sketch: values land in geometric buckets ``(γ^(k-1), γ^k]`` with
  ``γ = (1+α)/(1-α)``, so any value in bucket ``k`` is within relative
  error ``α`` (default 1%) of the bucket's midpoint estimate
  ``2·γ^k/(γ+1)``.  Merging two sketches is bucketwise count addition —
  the property MAX-of-locals aggregation lacks — so lah_top can compute
  a TRUE fleet p99 from per-peer sketches instead of the documented
  worst-across-instances fallback.  The wire form (:meth:`to_dict` /
  :meth:`from_dict`) is JSON- and msgpack-safe and travels inside the
  registry histogram snapshot (``/metrics.json`` → telemetry → lah_top).

Accuracy contract (tested): for positive values, ``quantile(q)`` is
within ``relative_accuracy`` of ``percentile(values, q,
method="nearest")`` — the sketch's rank walk uses the exact same
nearest-rank index, so the returned estimate sits in the bucket that
contains the true ranked value.  Zero/negative values collapse into a
dedicated zero bucket (latency series never see them); the ``max_bins``
cap collapses the LOWEST buckets first, which at α=1% only engages past
a ~e^40 dynamic range.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

DEFAULT_RELATIVE_ACCURACY = 0.01
DEFAULT_MAX_BINS = 2048

# wire-form discriminator: peers that predate sketches simply lack the
# "sketch" key in their histogram snapshots; readers key fallback on that
SKETCH_KIND = "ddsketch"


def percentile(
    values: Sequence[float], q: float, method: str = "linear",
    default: float = 0.0,
) -> float:
    """Percentile ``q`` (0–100) of ``values``; ``default`` when empty.

    ``linear`` is ``np.percentile``'s default interpolation replicated
    exactly (virtual index ``(q/100)·(n-1)``, two-sided lerp switching
    form at ``t >= 0.5`` for float symmetry); ``nearest`` is the
    macro-sim's nearest-rank (``round`` → banker's rounding, clamped).
    """
    vs = sorted(float(v) for v in values)
    if not vs:
        return default
    n = len(vs)
    if n == 1:
        return vs[0]
    rank = (float(q) / 100.0) * (n - 1)
    if method == "nearest":
        return vs[min(n - 1, max(0, int(round(rank))))]
    if method != "linear":
        raise ValueError(f"unknown percentile method {method!r}")
    lo = int(math.floor(rank))
    hi = min(int(math.ceil(rank)), n - 1)
    t = rank - lo
    d = vs[hi] - vs[lo]
    return vs[hi] - d * (1.0 - t) if t >= 0.5 else vs[lo] + d * t


class QuantileSketch:
    """Log-bucketed mergeable quantile sketch (see module docstring)."""

    __slots__ = (
        "relative_accuracy", "max_bins", "_gamma", "_log_gamma",
        "bins", "zero_count", "count", "sum", "min", "max",
    )

    def __init__(
        self,
        relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
        max_bins: int = DEFAULT_MAX_BINS,
    ):
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError("relative_accuracy must be in (0, 1)")
        self.relative_accuracy = float(relative_accuracy)
        self.max_bins = int(max_bins)
        self._gamma = (1.0 + relative_accuracy) / (1.0 - relative_accuracy)
        self._log_gamma = math.log(self._gamma)
        self.bins: dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # ---- accumulation ----

    def add(self, value: float) -> None:
        v = float(value)
        if v != v:  # NaN: a poisoned sample must not poison the sketch
            return
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.zero_count += 1
            return
        key = int(math.ceil(math.log(v) / self._log_gamma))
        self.bins[key] = self.bins.get(key, 0) + 1
        if len(self.bins) > self.max_bins:
            self._collapse_lowest()

    def _collapse_lowest(self) -> None:
        keys = sorted(self.bins)
        self.bins[keys[1]] += self.bins.pop(keys[0])

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        if abs(other.relative_accuracy - self.relative_accuracy) > 1e-12:
            raise ValueError(
                "cannot merge sketches with different relative_accuracy "
                f"({self.relative_accuracy} vs {other.relative_accuracy})"
            )
        self.count += other.count
        self.sum += other.sum
        self.zero_count += other.zero_count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for k, c in other.bins.items():
            self.bins[k] = self.bins.get(k, 0) + c
        while len(self.bins) > self.max_bins:
            self._collapse_lowest()
        return self

    # ---- queries ----

    def quantile(self, q: float) -> float:
        """Estimate percentile ``q`` (0–100); 0.0 when empty.

        The walk targets the same 0-based nearest-rank index as
        ``percentile(..., method="nearest")``, so the estimate lands in
        the bucket holding the true ranked value and inherits the α
        relative-error bound for positive values.
        """
        if self.count == 0:
            return 0.0
        rank = (float(q) / 100.0) * (self.count - 1)
        idx = min(self.count - 1, max(0, int(round(rank))))
        cum = self.zero_count
        if idx < cum:
            # the ranked value is non-positive; min is exact for rank 0
            # and the best available bound otherwise
            return min(self.min, 0.0)
        est = self.max
        for key in sorted(self.bins):
            cum += self.bins[key]
            if idx < cum:
                est = 2.0 * self._gamma ** key / (self._gamma + 1.0)
                break
        return min(self.max, max(self.min, est))

    # ---- wire form ----

    def to_dict(self) -> dict:
        """JSON/msgpack-safe wire form (int-keyed maps are JSON-hostile,
        so bins travel as sorted ``[key, count]`` pairs)."""
        return {
            "kind": SKETCH_KIND,
            "ra": self.relative_accuracy,
            "bins": [[k, self.bins[k]] for k in sorted(self.bins)],
            "zero": self.zero_count,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileSketch":
        if not isinstance(d, dict) or d.get("kind") != SKETCH_KIND:
            raise ValueError("not a sketch wire form")
        sk = cls(relative_accuracy=float(d["ra"]))
        sk.zero_count = int(d["zero"])
        sk.count = int(d["count"])
        sk.sum = float(d["sum"])
        sk.min = float(d["min"]) if d.get("min") is not None else math.inf
        sk.max = float(d["max"]) if d.get("max") is not None else -math.inf
        for pair in d["bins"]:
            k, c = int(pair[0]), int(pair[1])
            if c < 0:
                raise ValueError("negative bucket count")
            sk.bins[k] = sk.bins.get(k, 0) + c
        if sk.count < 0 or sk.zero_count < 0:
            raise ValueError("negative counts")
        return sk


def try_from_dict(d: object) -> Optional[QuantileSketch]:
    """Tolerant wire-form parse: None on anything malformed (lah_top's
    never-crash contract — a garbled peer section degrades to the MAX
    fallback, it does not take the fleet view down)."""
    try:
        return QuantileSketch.from_dict(d)  # type: ignore[arg-type]
    except (ValueError, KeyError, TypeError, IndexError, OverflowError):
        return None


def merge_dicts(dicts: Iterable[object]) -> Optional[QuantileSketch]:
    """Merge many wire-form sketches, skipping malformed ones; None when
    nothing merged (callers then fall back to the MAX rule, tagged)."""
    merged: Optional[QuantileSketch] = None
    for d in dicts:
        sk = try_from_dict(d)
        if sk is None:
            continue
        if merged is None:
            merged = sk
        else:
            try:
                merged.merge(sk)
            except ValueError:
                continue
    return merged
