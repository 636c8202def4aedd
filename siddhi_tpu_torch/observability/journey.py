"""Batch-journey tracing + critical-path attribution.

Counterpart of ``siddhi_tpu/observability/journey.py``: the same journey
record, ring and analyzer; the device stage's readiness probe
(``ready_of``) queries the CUDA event the pipeline already records, where
the reference asks ``jax.Array.is_ready``.

The spans of ``tracing.py`` time components in isolation; once the
dispatch pipeline overlaps stages (``core/query/completion.py``,
depth >= 2) they cannot say where a batch's END-TO-END latency actually
goes — the dispatch slice of a pipelined batch returns instantly and
the device time hides inside the ride. This module follows each batch
through the pipeline with host-side monotonic timestamps only (zero
changes inside the step code, and no added host sync) and attributes wall-clock per stage the way "Scaling Ordered
Stream Processing on Shared-Memory Multicores" (PAPERS.md) prescribes:
service time vs queueing time, per stage, with overlapped stages
attributed by MAX, not sum.

Stage glossary (exported as ``siddhi_stage_ms{query,stage}`` service
histograms and ``siddhi_stage_queue_ms{query,stage}`` queueing
histograms on ``GET /metrics``):

- ``pack``     — host event->columnar encode (``HostBatch.from_events``
                 / ``from_columns``), stamped where the batch is born.
- ``queue``    — residence in the @Async junction queue (enqueue ->
                 dequeue); a queue-only stage: its signal is queueing
                 time, service is the worker's re-batching (~0).
- ``dispatch`` — host work inside ``process_batch``: key computation,
                 capacity checks, routing prep, the step's launch (a
                 CUDA-graph replay on the card).
- ``device``   — observed device busy time. A pipelined batch rides in
                 flight; at drain a query of the CUDA event recorded
                 after its meta copy tells which side was waiting: output NOT
                 ready => the device worked the whole ride (service =
                 ride + meta pull), output ready => the device finished
                 mid-ride and only the pull is service — the ride was
                 the output parked waiting for the host (recorded as
                 ``device`` queueing/slack, NOT service). This is the
                 max-not-sum rule: when the host is the bottleneck the
                 ride must not ALSO count as device service.
- ``emit``     — output decode + downstream publish (sink/junction).

Cost model: near-zero when off — every instrumented site checks one
module flag and does nothing else. When on, a batch carries one small
``Journey`` object (a handful of floats); finished journeys land in
per-(query, stage) telemetry histograms plus a bounded ring buffer of
recent per-batch records (tracing never grows without bound).

The analyzer (:func:`critical_path_report`) aggregates the histograms
into a report naming the bottleneck stage per query: the stage with the
largest mean service time per batch — except a ``queue``-stage residence
dominating every service mean names the queue itself (the consumer is
stalled OUTSIDE its measured service, e.g. a wedged/throttled worker).
Utilization = stage busy time / observed wall. Served at
``GET /profile/critical_path``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

STAGES = ("pack", "queue", "dispatch", "device", "emit")

_DEFAULT_RING = 4096

# module flag: the ONE check every instrumented hot-path site pays when
# journey tracing is off (HostBatch.from_events runs per batch, not per
# event — same discipline as tracing.span)
_ENABLED = False
_enable_count = 0
_lock = threading.RLock()

# ring of recently finished journeys (dicts; see Journey.finish)
_RING: deque = deque(maxlen=_DEFAULT_RING)

# (app, query) -> [first_seen, last_seen] perf_counter span: the
# observed wall the analyzer divides stage busy time by
_WALL: Dict[Tuple[str, str], List[float]] = {}

# fault injection (tests / tools): stage -> seconds of planted service
# delay, consulted only by instrumented sites and only when enabled —
# FaultInjector.delay_stage is the public face (resilience/faults.py)
_DELAYS: Dict[str, float] = {}

# per-delivery-thread context: the @Async worker stamps the queue wait
# of the unit it is about to deliver; every receiving query's journey
# picks it up (one delivery fans out to N receivers)
_TLS = threading.local()


def enabled() -> bool:
    return _ENABLED


def enable(ring_capacity: Optional[int] = None) -> None:
    """Turn journey tracing on (refcounted: one ``disable()`` per
    ``enable()``; the first enable resets the ring and wall tracking)."""
    global _ENABLED, _enable_count, _RING
    with _lock:
        _enable_count += 1
        if not _ENABLED:
            _RING = deque(maxlen=int(ring_capacity or _DEFAULT_RING))
            _WALL.clear()
            _ENABLED = True
        elif ring_capacity is not None and ring_capacity != _RING.maxlen:
            _RING = deque(_RING, maxlen=int(ring_capacity))


def disable(force: bool = False) -> None:
    global _ENABLED, _enable_count
    with _lock:
        _enable_count = 0 if force else max(0, _enable_count - 1)
        if _enable_count == 0:
            _ENABLED = False


def forget_app(app_name: str) -> None:
    """Drop an app's wall-tracking entries (called at runtime shutdown):
    a redeployed same-named app must not inherit a dead app's
    first-seen timestamp — its utilization would read ~0% across the
    gap — and app churn must not grow the map without bound."""
    with _lock:
        for key in [k for k in _WALL if k[0] == app_name]:
            del _WALL[key]


def inject_delay(stage: str, seconds: float) -> None:
    """Plant a service delay inside an instrumented stage (the
    critical-path tests' known bottleneck). Only ``pack`` is a direct
    injection point today; queue bottlenecks are planted with
    ``FaultInjector.delay_worker`` (the consumer side)."""
    if stage not in STAGES:
        raise ValueError(f"unknown journey stage '{stage}' — one of {STAGES}")
    _DELAYS[stage] = float(seconds)


def clear_delays() -> None:
    _DELAYS.clear()


def maybe_delay(stage: str) -> None:
    d = _DELAYS.get(stage)
    if d:
        time.sleep(d)


def ring() -> list:
    """Snapshot of the recent-journeys ring (newest last)."""
    with _lock:
        return list(_RING)


def ready_of(ref) -> bool:
    """Has the card finished the work behind ``ref``? A
    ``torch.cuda.Event`` (the one the pipeline records after a batch's
    meta copy) answers with ``query()``; a CUDA tensor about to be pulled
    at once (the synchronous path) with its device's current stream's
    ``query()``. Neither waits. Anything else (a CPU tensor, numpy, None)
    is ready, as numpy is in the reference."""
    query = getattr(ref, "query", None)
    if callable(query):
        return bool(query())
    try:
        import torch
    except ImportError:   # pragma: no cover — the port always has torch
        return True
    if isinstance(ref, torch.Tensor) and ref.is_cuda:
        return bool(torch.cuda.current_stream(ref.device).query())
    return True


# ------------------------------------------------------- delivery context

def push_delivery_queue_wait(enq_t: Optional[float]):
    """Open one junction delivery's scope on this thread: receivers of
    THIS delivery read the unit's queue residence (None = not from an
    @Async queue). Returns the previous value for the paired
    :func:`pop_delivery_queue_wait` — a nested delivery (a receiver's
    synchronous emit cascading into a downstream junction) masks the
    outer wait instead of charging the upstream queue residence to
    queries that never sat in that queue."""
    prev = getattr(_TLS, "queue_ms", None)
    _TLS.queue_ms = (None if enq_t is None
                     else (time.perf_counter() - enq_t) * 1000.0)
    return prev


def pop_delivery_queue_wait(prev) -> None:
    _TLS.queue_ms = prev


def _delivery_queue_ms() -> Optional[float]:
    return getattr(_TLS, "queue_ms", None)


# ---------------------------------------------------------------- journey

class Journey:
    """Per-batch trace context: stamped at pack, carried on the
    ``HostBatch`` through junction delivery, forked per receiving query,
    riding the batch's ``QueryCompletion``/``FusedCompletion`` through
    the pump, finished after emit. All timestamps host-monotonic."""

    __slots__ = ("pack_ms", "queue_ms", "_t_disp0", "dispatch_ms",
                 "_t_disp1", "_t_drain0", "ready", "pull_ms", "emit_ms")

    def __init__(self, pack_ms: Optional[float] = None):
        self.pack_ms = pack_ms
        self.queue_ms: Optional[float] = None
        self._t_disp0: Optional[float] = None
        self.dispatch_ms = 0.0
        self._t_disp1: Optional[float] = None
        self._t_drain0: Optional[float] = None
        self.ready: Optional[bool] = None
        self.pull_ms = 0.0
        self.emit_ms = 0.0

    # one journey object is stamped on the batch at pack time; each
    # receiving query forks its own (stage times are per query)
    def fork(self) -> "Journey":
        return Journey(pack_ms=self.pack_ms)

    def begin_dispatch(self) -> None:
        self.queue_ms = _delivery_queue_ms()
        self._t_disp0 = time.perf_counter()

    def end_dispatch(self) -> None:
        if self._t_disp0 is not None and self._t_disp1 is None:
            self._t_disp1 = time.perf_counter()
            self.dispatch_ms = (self._t_disp1 - self._t_disp0) * 1000.0

    def pre_drain(self, ready: bool) -> None:
        """Stamped immediately BEFORE the meta pull, with the output's
        ``is_ready`` verdict — the pivot of the device attribution."""
        self._t_drain0 = time.perf_counter()
        self.ready = bool(ready)

    def drained(self, pull_ms: float) -> None:
        self.pull_ms = float(pull_ms)

    def device_times(self) -> Tuple[float, float]:
        """(service_ms, queue_ms) of the device stage — see the module
        docstring's max-not-sum rule."""
        ride = 0.0
        if self._t_drain0 is not None and self._t_disp1 is not None:
            ride = max(0.0, (self._t_drain0 - self._t_disp1) * 1000.0)
        if self.ready is False:
            return ride + self.pull_ms, 0.0
        # ready (or never observed): only the pull is known device work;
        # the ride was the finished output parked waiting for the host
        return self.pull_ms, ride

    def finish(self, app_context, names) -> None:
        """Record this journey's stage times into the app's telemetry
        histograms (one set per query name — a fused group records the
        shared batch under every member) and the recent-journeys ring."""
        if not _ENABLED:
            return
        tel = getattr(app_context, "telemetry", None)
        if tel is None:
            return
        app = getattr(app_context, "name", "")
        dev_service, dev_queue = self.device_times()
        now = time.perf_counter()
        for name in names:
            if self.pack_ms is not None:
                tel.histogram(
                    f"stage.{name}.pack.service_ms").record(self.pack_ms)
            if self.queue_ms is not None:
                tel.histogram(
                    f"stage.{name}.queue.queue_ms").record(self.queue_ms)
            tel.histogram(
                f"stage.{name}.dispatch.service_ms").record(self.dispatch_ms)
            tel.histogram(
                f"stage.{name}.device.service_ms").record(dev_service)
            tel.histogram(
                f"stage.{name}.device.queue_ms").record(dev_queue)
            tel.histogram(f"stage.{name}.emit.service_ms").record(self.emit_ms)
        with _lock:
            # under the lock: forget_app's clear must not interleave
            # with this read-modify-write (a last in-flight finish
            # re-inserting a dead app's first-seen timestamp)
            for name in names:
                wall = _WALL.get((app, name))
                if wall is None:
                    t0 = self._t_disp0 if self._t_disp0 is not None else now
                    _WALL[(app, name)] = [t0, now]
                else:
                    wall[1] = now
            _RING.append({
                "app": app, "queries": list(names),
                "pack_ms": self.pack_ms, "queue_ms": self.queue_ms,
                "dispatch_ms": self.dispatch_ms,
                "device_service_ms": dev_service,
                "device_queue_ms": dev_queue,
                "emit_ms": self.emit_ms, "t": now,
            })


def stamp_pack(batch, t0: float) -> None:
    """Attach a fresh journey (pack service = now - t0) to a batch just
    built by ``HostBatch.from_events``/``from_columns``. Caller already
    checked :func:`enabled` — this is the pack-stage stamp the rest of
    the pipeline carries forward."""
    batch.journey = Journey(pack_ms=(time.perf_counter() - t0) * 1000.0)


def stamp_pack_ms(batch, pack_ms: float) -> None:
    """Pack stamp with a caller-computed service time — the parallel
    ingest pack path (``core/event._parallel_from_events``) attributes
    max-over-sub-batches plus the serial merge, per the max-not-sum rule
    (concurrent packer time must not count once per worker)."""
    batch.journey = Journey(pack_ms=float(pack_ms))


def begin(batch) -> Journey:
    """Per-receiver journey for a delivered batch: forks the batch's
    pack stamp (N receivers must not share mutable stage state) and
    opens the dispatch stage."""
    src = getattr(batch, "journey", None)
    jr = src.fork() if src is not None else Journey()
    jr.begin_dispatch()
    return jr


# --------------------------------------------------------------- analyzer

# residence in the queue stage must dominate every service mean by this
# factor before the analyzer blames the queue itself: queueing time is
# a symptom, and a modest wait in front of a genuinely busy stage should
# name the busy stage, not the line in front of it
_QUEUE_DOMINANCE = 2.0

_STAGE_KINDS = ("service", "queue")


def _parse_stage_hists(hist_snapshot: dict) -> Dict[str, dict]:
    """``stage.<query>.<stage>.<kind>_ms`` histogram snapshots grouped
    as {query: {stage: {kind: snap}}} (query names may contain dots —
    the stage/kind tail is fixed, so parse from the right)."""
    out: Dict[str, dict] = {}
    for name, snap in hist_snapshot.items():
        if not name.startswith("stage."):
            continue
        rest = name[len("stage."):]
        parts = rest.rsplit(".", 2)
        if len(parts) != 3:
            continue
        query, stage, kind_ms = parts
        if not kind_ms.endswith("_ms"):
            continue
        kind = kind_ms[:-3]
        if stage not in STAGES or kind not in _STAGE_KINDS:
            continue
        out.setdefault(query, {}).setdefault(stage, {})[kind] = snap
    return out


def _parse_device_signals(hist_snapshot: dict,
                          gauge_snapshot: dict) -> Dict[str, dict]:
    """``device.<query>.<slot>`` instrument histograms paired with their
    ``.capacity`` gauges, grouped per query (slot names come from the
    DEVICE_SLOTS declaration in export.py — the graftlint-R6-checked
    tuple, so a newly declared slot is visible here by construction;
    query names may contain dots, so parse from the right against the
    known slot set)."""
    from siddhi_tpu_torch.observability.export import DEVICE_SLOTS

    slots = sorted(DEVICE_SLOTS, key=len, reverse=True)
    out: Dict[str, dict] = {}
    for name, snap in hist_snapshot.items():
        if not name.startswith("device."):
            continue
        rest = name[len("device."):]
        for slot in slots:
            if rest.endswith("." + slot):
                query = rest[: -len(slot) - 1]
                cap = gauge_snapshot.get(f"device.{query}.{slot}.capacity")
                out.setdefault(query, {})[slot] = {
                    "snap": snap, "capacity": cap}
                break
    return out


def _device_structure(device_slots: Optional[dict]) -> Optional[dict]:
    """The most saturated device structure of one query, from its
    drained instrument histograms: max p99/capacity ratio across slots
    with a known capacity — the thing to name when the device stage is
    the bottleneck ('join right side partition fill p99 = 0.97 of
    Wp')."""
    from siddhi_tpu_torch.observability.instruments import (
        RESIDUAL_SLOTS, SLOT_CAP_NAMES, SLOT_LABELS)

    best = None
    for slot, rec in (device_slots or {}).items():
        cap = rec.get("capacity")
        if not cap or cap != cap:      # missing or NaN denominator
            continue
        label = SLOT_LABELS.get(slot, slot)
        cap_name = SLOT_CAP_NAMES.get(slot, "capacity")
        if slot in RESIDUAL_SLOTS:
            # a residual saturates toward ZERO: the worst case over the
            # window is the MINIMUM residual seen, not a high quantile
            # (p99 would be the healthiest batch)
            quoted = float(rec["snap"].get("min", 0.0))
            ratio = max(0.0, 1.0 - quoted / float(cap))
            text = (f"{label} min = {quoted:.0f} of {cap_name} "
                    f"({ratio:.2f} saturated)")
        else:
            quoted = float(rec["snap"].get("p99", 0.0))
            ratio = quoted / float(cap)
            text = f"{label} p99 = {ratio:.2f} of {cap_name}"
        if best is None or ratio > best["ratio"]:
            best = {
                "slot": slot,
                "label": label,
                # the quoted statistic: p99 for fill-style slots, MIN
                # for residuals (the field name must not lie about it)
                "stat": "min" if slot in RESIDUAL_SLOTS else "p99",
                "value": round(quoted, 3),
                "capacity": float(cap),
                "ratio": round(ratio, 4),
                "text": text,
            }
    return best


def _query_report(app: str, query: str, stages: Dict[str, dict],
                  device_slots: Optional[dict] = None) -> dict:
    per_stage = {}
    for stage in STAGES:
        kinds = stages.get(stage)
        if not kinds:
            continue
        service = kinds.get("service") or {}
        queue = kinds.get("queue") or {}
        per_stage[stage] = {
            "batches": int(service.get("count") or queue.get("count") or 0),
            "service_ms": service,
            "queue_ms": queue,
            "busy_ms": round(float(service.get("sum", 0.0)), 3),
            "mean_service_ms": round(
                float(service.get("sum", 0.0))
                / max(1, int(service.get("count", 0))), 4),
            "mean_queue_ms": round(
                float(queue.get("sum", 0.0))
                / max(1, int(queue.get("count", 0))), 4),
        }
    wall = _WALL.get((app, query))
    wall_ms = (wall[1] - wall[0]) * 1000.0 if wall else 0.0

    # bottleneck: largest mean service per batch; a queue-stage
    # residence dominating every service mean names the queue itself
    best_stage, best_mean = None, -1.0
    for stage, rec in per_stage.items():
        if stage == "queue":
            continue
        if rec["mean_service_ms"] > best_mean:
            best_stage, best_mean = stage, rec["mean_service_ms"]
    queue_rec = per_stage.get("queue")
    if queue_rec is not None:
        q_mean = queue_rec["mean_queue_ms"]
        if q_mean > 0 and q_mean >= _QUEUE_DOMINANCE * max(best_mean, 0.0):
            best_stage, best_mean = "queue", q_mean
    structure = _device_structure(device_slots)
    bottleneck = None
    if best_stage is not None:
        rec = per_stage[best_stage]
        busy = (float(rec["queue_ms"].get("sum", 0.0))
                if best_stage == "queue" else rec["busy_ms"])
        bottleneck = {
            "stage": best_stage,
            "kind": "queueing" if best_stage == "queue" else "service",
            "mean_ms": round(best_mean, 4),
            "utilization": round(min(1.0, busy / wall_ms), 4)
            if wall_ms > 0 else None,
        }
        if best_stage == "device" and structure is not None:
            # the device is the bottleneck AND its instruments say which
            # structure is saturated — name it right in the verdict
            bottleneck["structure"] = structure["text"]
    report = {"stages": per_stage, "wall_ms": round(wall_ms, 3),
              "bottleneck": bottleneck}
    if structure is not None:
        report["device_structure"] = structure
    return report


def critical_path_report(manager, app_name: Optional[str] = None) -> dict:
    """Aggregate the per-stage histograms into the critical-path report
    (per app, per query): stage service/queue quantiles, busy time,
    observed wall, and the named bottleneck stage with its utilization.
    Correct under pipelining: overlapped stages were attributed by max
    at record time (see ``Journey.device_times``), so a host-bound
    pipeline never shows the device as busy for the full wall."""
    runtimes = manager.app_runtimes
    if app_name is not None:
        rt = runtimes.get(app_name)
        if rt is None:
            raise KeyError(f"app '{app_name}' is not deployed")
        runtimes = {app_name: rt}
    apps = {}
    for name in sorted(runtimes):
        rt = runtimes[name]
        tel = rt.app_context.telemetry
        snap = tel.snapshot()
        hists = snap.get("histograms", {})
        # device instruments (on by default, independent of journey
        # tracing): when the device stage is the bottleneck, the report
        # names the saturated structure behind it
        device = _parse_device_signals(hists, snap.get("gauges", {}))
        queries = {
            q: _query_report(name, q, stages, device_slots=device.get(q))
            for q, stages in sorted(_parse_stage_hists(hists).items())
        }
        apps[name] = {"queries": queries}
    return {
        "enabled": enabled(),
        "stage_glossary": list(STAGES),
        "recent_journeys": len(_RING),
        "apps": apps,
    }
