"""Statistics: throughput/latency trackers plus DETAIL-level memory and
buffered-events probes, with OFF/BASIC/DETAIL levels.

Counterpart of ``siddhi_tpu/core/util/statistics.py``. Mirror of reference ``util/statistics/SiddhiStatisticsManager.java:35`` +
``ThroughputTracker`` / ``LatencyTracker`` metrics hung off junctions and
query runtimes (``StreamJunction.java:153-155``). Counters are plain host
ints guarded by the GIL (incremented at batch granularity, not per event —
the columnar pump makes per-batch the natural unit).

Levels: OFF (no collection), BASIC (throughput per junction/query),
DETAIL (adds per-query step latency, per-element state memory and
buffered-event depths). Memory is the dense-state answer to the
reference's reflective deep-size walk
(``util/statistics/memory/ObjectSizeCalculator.java:66``,
``SiddhiAppRuntimeImpl.monitorQueryMemoryUsage:757-782``): every stateful
element is a pytree of arrays, so its footprint is the sum of leaf
``nbytes`` — exact and O(leaves), where the reference pays a reflective
object-graph walk. (The port's state is dicts and tuples of tensors; a
tensor's ``nbytes`` is read from its metadata, with no device sync.)
Buffered events mirror ``monitorBufferedEvents``
(``SiddhiAppRuntimeImpl.java:784-821`` / ``StreamJunction.
getBufferedEvents:356-361``): @Async junction queue depths. Enable with ``@app:statistics('true')`` or
``@app:statistics(level='detail', reporter='console', interval='5 sec')``;
snapshot programmatically with ``SiddhiAppRuntime.statistics()``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional


def pytree_nbytes(tree) -> int:
    """Total bytes of every tensor or array in a (possibly nested) state
    dict, list or tuple: the exact footprint of dense device or host
    state, read from metadata alone (no device sync)."""
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(v) for v in tree)
    nb = getattr(tree, "nbytes", None)
    return int(nb) if isinstance(nb, int) else 0

OFF, BASIC, DETAIL = 0, 1, 2


def latency_t0(sm: Optional["StatisticsManager"],
               level: int = DETAIL) -> Optional[float]:
    """Start a latency measurement: ``perf_counter()`` when ``sm`` collects
    at ``level``, else None. Pair with ``record_elapsed_ms`` — the shared
    timing pattern of the query/join/NFA runtimes (one helper so the
    copies cannot drift). It times the host's dispatch of a step and
    never waits for the device: a sync here would stall the dispatch
    pipeline."""
    if sm is not None and sm.level >= level:
        return time.perf_counter()
    return None


def record_elapsed_ms(sm: Optional["StatisticsManager"], name: str,
                      t0: Optional[float]) -> None:
    """Record elapsed ms since ``t0`` on ``sm``'s tracker; no-op when the
    paired ``latency_t0`` returned None."""
    if t0 is not None:
        sm.latency_tracker(name).record((time.perf_counter() - t0) * 1000.0)

_LEVELS = {"off": OFF, "basic": BASIC, "detail": DETAIL,
           "false": OFF, "true": BASIC}


def parse_level(s: Optional[str]) -> int:
    if s is None:
        return BASIC
    lv = _LEVELS.get(s.strip().lower())
    if lv is None:
        raise ValueError(f"unknown statistics level '{s}'")
    return lv


class ThroughputTracker:
    """Event counts + rate since creation/reset."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.batches = 0
        self._t0 = time.perf_counter()

    def add(self, n: int):
        self.count += n
        self.batches += 1

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self.count / dt if dt > 0 else 0.0

    def reset(self):
        self.count = 0
        self.batches = 0
        self._t0 = time.perf_counter()


class LatencyTracker:
    """Per-batch processing latency aggregates (ms) with tail
    percentiles: every record also lands in a fixed-bucket log-spaced
    histogram (``observability/histogram.py``), so the avg-only view
    the reference's LatencyTracker offers is extended with p50/p95/p99
    — the numbers the PERF.md batching decisions actually hinge on."""

    def __init__(self, name: str):
        from siddhi_tpu_torch.observability.histogram import Histogram

        self.name = name
        self.n = 0
        self.total_ms = 0.0
        self.max_ms = 0.0
        self.hist = Histogram()

    def record(self, ms: float):
        self.n += 1
        self.total_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms
        self.hist.record(ms)

    @property
    def avg_ms(self) -> float:
        return self.total_ms / self.n if self.n else 0.0

    @property
    def p50_ms(self) -> float:
        return self.hist.quantile(0.50)

    @property
    def p95_ms(self) -> float:
        return self.hist.quantile(0.95)

    @property
    def p99_ms(self) -> float:
        return self.hist.quantile(0.99)

    def reset(self):
        self.n = 0
        self.total_ms = 0.0
        self.max_ms = 0.0
        self.hist.reset()


class StatisticsManager:
    """Per-app metric registry (reference SiddhiStatisticsManager)."""

    def __init__(self, level: int = OFF, reporter: Optional[str] = None,
                 interval_ms: int = 60_000):
        self.level = level
        self.reporter = reporter
        self.interval_ms = interval_ms
        self._lock = threading.RLock()
        self.throughput: Dict[str, ThroughputTracker] = {}
        self.latency: Dict[str, LatencyTracker] = {}
        # DETAIL probes, polled at report time (state footprints move with
        # every batch — sampling at the report beats tracking per step)
        self.memory_probes: Dict[str, Callable[[], int]] = {}
        self.buffer_probes: Dict[str, Callable[[], int]] = {}
        # named event counters (resilience: worker restarts, WAL replayed/
        # dropped batches, source/sink retries, peer recoveries) — rare,
        # operationally load-bearing events counted at every level > OFF
        self.counters: Dict[str, int] = {}
        self._job = None

    # ------------------------------------------------------------ trackers

    def throughput_tracker(self, name: str) -> ThroughputTracker:
        with self._lock:
            t = self.throughput.get(name)
            if t is None:
                t = self.throughput[name] = ThroughputTracker(name)
            return t

    def latency_tracker(self, name: str) -> LatencyTracker:
        with self._lock:
            t = self.latency.get(name)
            if t is None:
                t = self.latency[name] = LatencyTracker(name)
            return t

    def register_memory_probe(self, name: str, probe: Callable[[], int]):
        """Register a state-footprint probe (bytes), polled at DETAIL
        report time — the analog of monitorQueryMemoryUsage registering a
        MemoryUsageTracker per query/table/window/aggregation."""
        with self._lock:
            self.memory_probes[name] = probe

    def register_buffer_probe(self, name: str, probe: Callable[[], int]):
        """Register a buffered-events probe (pending event/batch count) —
        the analog of monitorBufferedEvents on @Async junctions."""
        with self._lock:
            self.buffer_probes[name] = probe

    def count(self, name: str, n: int = 1):
        """Bump a named event counter (see ``counters``)."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # ------------------------------------------------------------- control

    def set_level(self, level: int):
        self.level = level

    def start_reporting(self, scheduler):
        if self.reporter == "console" and scheduler is not None:
            # with statistics OFF the tick prints nothing (the reference
            # stops its reporter when stats are disabled —
            # StatisticsTestCase test2)
            self._job = scheduler.schedule_periodic(
                self.interval_ms,
                lambda ts: print(self.format_report())
                if self.level > OFF else None)

    def stop_reporting(self, scheduler):
        if self._job is not None and scheduler is not None:
            scheduler.cancel(self._job)
            self._job = None

    # -------------------------------------------------------------- report

    def report(self) -> dict:
        with self._lock:
            out = {
                "level": {OFF: "off", BASIC: "basic", DETAIL: "detail"}[self.level],
                "throughput": {
                    n: {"events": t.count, "batches": t.batches,
                        "events_per_sec": round(t.rate(), 1)}
                    for n, t in self.throughput.items()
                },
                "latency": {
                    n: {"batches": t.n, "avg_ms": round(t.avg_ms, 3),
                        "max_ms": round(t.max_ms, 3),
                        "total_ms": round(t.total_ms, 3),
                        "p50_ms": round(t.p50_ms, 3),
                        "p95_ms": round(t.p95_ms, 3),
                        "p99_ms": round(t.p99_ms, 3)}
                    for n, t in self.latency.items()
                },
            }
            if self.counters:
                out["counters"] = dict(self.counters)
            if self.level >= DETAIL:
                mem = {}
                for n, probe in self.memory_probes.items():
                    try:
                        mem[n] = int(probe())
                    except Exception:
                        mem[n] = -1   # probe raced a teardown/regrow
                out["memory_bytes"] = mem
                out["memory_total_bytes"] = sum(v for v in mem.values()
                                                if v > 0)
                buf = {}
                for n, probe in self.buffer_probes.items():
                    try:
                        buf[n] = int(probe())
                    except Exception:
                        buf[n] = -1
                out["buffered_events"] = buf
            return out

    def format_report(self) -> str:
        import json

        return json.dumps(self.report(), indent=1)

    def reset(self):
        with self._lock:
            for t in self.throughput.values():
                t.reset()
            for t in self.latency.values():
                t.reset()
            self.counters.clear()
