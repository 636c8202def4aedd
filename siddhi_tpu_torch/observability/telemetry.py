"""Telemetry registry: gauges, counters and latency histograms.

Counterpart of ``siddhi_tpu/observability/telemetry.py``. Complements
``core/util/statistics.StatisticsManager`` (throughput and latency
trackers behind ``@app:statistics``) with the signals a deployment scrapes
continuously:

- **gauges**: sampled callables (ingest-WAL size, the serving tier's
  admission-pool depth, aggregation bucket and shard counts), registered
  once at wiring time and read at scrape time; a dead probe reports NaN
  instead of failing the scrape;
- **counters**: monotone event counts outside the statistics levels
  (query sheds, shard rebuilds, wire-frame ingest);
- **histograms**: always-on percentile series (aggregation fold latency,
  the serving tier's fan-out, merge and query times).

One registry per app (``SiddhiAppContext.telemetry``, always present) plus
one process-global registry (``global_registry()``) for sites with no app
context; ``export.py`` merges both into every scrape.

The reference's jit-compile events (``InstrumentedJit``, ``record_jit``,
``instrument_jit``) time ``jax.jit`` compiles; the port's counterpart
would time kernel builds and CUDA events, and waits for ROADMAP A.10.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict


class TelemetryRegistry:
    def __init__(self):
        self._lock = threading.RLock()
        self._gauges: Dict[str, Callable[[], float]] = {}
        self.counters: Dict[str, int] = {}
        # name -> observability.histogram.Histogram (ms by convention)
        self.histograms: Dict[str, object] = {}

    # ------------------------------------------------------------- gauges

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Register (or replace) a sampled gauge."""
        with self._lock:
            self._gauges[name] = fn

    def remove_gauge(self, name: str) -> None:
        with self._lock:
            self._gauges.pop(name, None)

    def read_gauges(self) -> Dict[str, float]:
        with self._lock:
            items = list(self._gauges.items())
        out = {}
        for name, fn in items:
            try:
                out[name] = float(fn())
            except Exception:  # noqa: BLE001 — a dead probe must not
                out[name] = math.nan  # fail the scrape
        return out

    # ----------------------------------------------------------- counters

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # ---------------------------------------------------------- histograms

    def histogram(self, name: str):
        """Get-or-create a named log-bucket latency histogram
        (``observability/histogram.py``). Idempotent: call sites keep the
        returned object and record on it directly."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                from siddhi_tpu_torch.observability.histogram import Histogram

                h = self.histograms[name] = Histogram()
            return h

    # ------------------------------------------------------------ reading

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            hists = {k: h.snapshot() for k, h in self.histograms.items()}
        out = {"gauges": self.read_gauges(), "counters": counters}
        if hists:
            out["histograms"] = hists
        return out

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            for h in self.histograms.values():
                h.reset()


_GLOBAL = TelemetryRegistry()


def global_registry() -> TelemetryRegistry:
    """Process-wide registry for sites with no app context (the serving
    tier's admission pool)."""
    return _GLOBAL
