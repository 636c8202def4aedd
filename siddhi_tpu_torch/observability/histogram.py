"""Fixed-bucket log-spaced latency histograms (HDR-style).

Counterpart of ``siddhi_tpu/observability/histogram.py``, whole.

The reference hangs metrics-core ``Histogram``s (exponentially-decaying
reservoirs) off junctions and query runtimes; the equivalent here is a
fixed array of log-spaced buckets — O(1) lock-free-under-the-GIL record,
O(buckets) quantile read, zero allocation after construction, and a
bounded, deterministic memory footprint that snapshots trivially.

Bucket ``i`` covers ``(min_value * g^(i-1), min_value * g^i]`` with
bucket 0 catching everything at or below ``min_value``; quantiles report
the geometric midpoint of the hit bucket (clamped to the observed
min/max), so the relative error is bounded by ``sqrt(g) - 1`` — ~3.5%
at the default growth of 1.07, comparable to a 2-significant-digit HDR
histogram. The default domain (1 us .. ~100 s in ms units) spans every
latency this engine produces, from a host dict probe to a first CUDA
kernel build.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

_DEFAULT_MIN = 1e-3     # 1 us, in ms units
_DEFAULT_GROWTH = 1.07
_DEFAULT_BUCKETS = 288  # 1e-3 * 1.07^287 ≈ 2.7e5 ms ≈ 4.5 min


class Histogram:
    """Log-bucket histogram of non-negative values (ms by convention)."""

    __slots__ = ("counts", "count", "total", "min_seen", "max_seen",
                 "min_value", "growth", "_inv_log_g", "n_buckets")

    def __init__(self, min_value: float = _DEFAULT_MIN,
                 growth: float = _DEFAULT_GROWTH,
                 n_buckets: int = _DEFAULT_BUCKETS):
        if not (growth > 1.0 and min_value > 0 and n_buckets > 1):
            raise ValueError("Histogram needs growth > 1, min_value > 0, "
                             "n_buckets > 1")
        self.min_value = float(min_value)
        self.growth = float(growth)
        self.n_buckets = int(n_buckets)
        self._inv_log_g = 1.0 / math.log(self.growth)
        self.counts: List[int] = [0] * self.n_buckets
        self.count = 0
        self.total = 0.0
        self.min_seen = math.inf
        self.max_seen = 0.0

    # ------------------------------------------------------------- record

    def record(self, value: float) -> None:
        """O(1): one log, one clamp, one increment (GIL-atomic enough for
        telemetry — a lost increment under a rare race skews a count by
        one, never corrupts the structure)."""
        v = float(value)
        if v < 0 or v != v:      # negative / NaN: clock skew artifacts
            return
        if v <= self.min_value:
            i = 0
        else:
            i = int(math.log(v / self.min_value) * self._inv_log_g) + 1
            if i >= self.n_buckets:
                i = self.n_buckets - 1
        self.counts[i] += 1
        self.count += 1
        self.total += v
        if v < self.min_seen:
            self.min_seen = v
        if v > self.max_seen:
            self.max_seen = v

    # -------------------------------------------------------------- reads

    def _bucket_mid(self, i: int) -> float:
        if i == 0:
            mid = self.min_value * 0.5
        else:
            # geometric midpoint of (min * g^(i-1), min * g^i]
            mid = self.min_value * self.growth ** (i - 0.5)
        if self.count:
            mid = min(max(mid, self.min_seen), self.max_seen)
        return mid

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]; 0.0 when empty."""
        if self.count == 0:
            return 0.0
        if q <= 0:
            return self.min_seen
        if q >= 1:
            return self.max_seen
        target = max(1, math.ceil(q * self.count))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self._bucket_mid(i)
        return self.max_seen   # pragma: no cover — counts always sum up

    def percentiles(self) -> Dict[str, float]:
        return {
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        out = {"count": self.count, "sum": self.total,
               "min": self.min_seen if self.count else 0.0,
               "max": self.max_seen}
        out.update(self.percentiles())
        return out

    def reset(self) -> None:
        self.counts = [0] * self.n_buckets
        self.count = 0
        self.total = 0.0
        self.min_seen = math.inf
        self.max_seen = 0.0

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram with IDENTICAL bucketing into this one
        (per-shard aggregation)."""
        if (other.n_buckets != self.n_buckets
                or other.growth != self.growth
                or other.min_value != self.min_value):
            raise ValueError("cannot merge histograms with different buckets")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.min_seen = min(self.min_seen, other.min_seen)
        self.max_seen = max(self.max_seen, other.max_seen)


def percentile_bounds(hist: Histogram) -> Optional[dict]:
    """Convenience for reports: None when empty, snapshot otherwise."""
    return hist.snapshot() if hist.count else None
