"""Read-only signal snapshot for the autopilot controller.

Counterpart of ``siddhi_tpu/autopilot/signals.py``. Everything is
assembled from surfaces the engine already exports:
``journey.critical_path_report`` (stage quantiles and the named
bottleneck), the app's ``TelemetryRegistry`` snapshot
(``pipeline.*.inflight``, ``ingest.pool.*``, the ``quota.*`` utilization
gauges, per-step compile counts) and the join engines' host occupancy
(``DeviceJoinEngine.shrink_candidates``: the last drained instrument lanes
or the host mirror). A ``collect`` never reads a tensor's values, so it
never synchronizes the card: the same discipline as a ``GET /metrics``
scrape.

In the port a "compile" is a step build plus, on the card, its CUDA-graph
capture (``observability/telemetry.py``), so the compile-storm signal
climbs at every capture, a re-install by an actuator included.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, Optional


@dataclass
class SignalSnapshot:
    """One observation of an app runtime, host-side only."""

    app: str
    # per-query bottleneck verdicts of the critical-path report:
    # {query: {"stage", "kind", "mean_ms", "utilization", ...}}
    bottlenecks: Dict[str, dict] = field(default_factory=dict)
    gauges: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    # the sum of per-step compiles: the compile-storm signal
    jit_compiles: int = 0
    # quota-utilization gauges with the "quota." prefix stripped
    quota: Dict[str, float] = field(default_factory=dict)
    # max pipeline.<owner>.inflight over owners (0 = nothing pending)
    pipeline_inflight: float = 0.0
    pipeline_depth: int = 1
    # ingest pool: configured workers / utilization (None = no pool)
    pool_workers: Optional[int] = None
    pool_utilization: float = 0.0
    pool_queue_depth: float = 0.0
    # join sides whose Wp could shrink back after a skew burst:
    # {query: {side: (current_wp, shrink_target)}}
    join_shrinkable: Dict[str, dict] = field(default_factory=dict)
    # routed queries: {query: shard_count}
    routed: Dict[str, int] = field(default_factory=dict)
    fused_groups: int = 0

    def worst_bottleneck(self) -> Optional[dict]:
        """The highest-utilization bottleneck verdict, with its query name
        under ``"query"`` (None when journeys are off or no batch has
        completed yet)."""
        worst = None
        for q, b in self.bottlenecks.items():
            if not b or b.get("stage") is None:
                continue
            if worst is None or (b.get("utilization") or 0.0) > \
                    (worst.get("utilization") or 0.0):
                worst = dict(b)
                worst["query"] = q
        return worst


def collect(app_runtime) -> SignalSnapshot:
    """One :class:`SignalSnapshot` of ``app_runtime`` from its existing
    observability surfaces. Host reads only."""
    from siddhi_tpu_torch.observability import journey

    ctx = app_runtime.app_context
    sig = SignalSnapshot(app=ctx.name)
    tel = ctx.telemetry
    if tel is not None:
        snap = tel.snapshot()
        sig.gauges = dict(snap.get("gauges", {}))
        sig.counters = dict(snap.get("counters", {}))
        sig.jit_compiles = sum(
            int(v.get("compiles", 0)) for v in snap.get("jit", {}).values())
    for name, val in sig.gauges.items():
        if name.startswith("quota."):
            sig.quota[name[len("quota."):]] = val
        elif name.startswith("pipeline.") and name.endswith(".inflight"):
            sig.pipeline_inflight = max(sig.pipeline_inflight, val or 0.0)
    sig.pipeline_depth = int(getattr(ctx, "pipeline_depth", 1) or 1)
    pool = ctx.ingest_pack_pool
    if pool is not None:
        sig.pool_workers = int(pool.workers)
        sig.pool_utilization = float(
            sig.gauges.get("ingest.pool.utilization", 0.0) or 0.0)
        sig.pool_queue_depth = float(
            sig.gauges.get("ingest.pool.queue_depth", 0.0) or 0.0)
    if journey.enabled():
        # the report takes a manager: scope it to this one runtime
        shim = SimpleNamespace(app_runtimes={ctx.name: app_runtime})
        try:
            rep = journey.critical_path_report(shim, ctx.name)
            queries = rep["apps"].get(ctx.name, {}).get("queries", {})
            sig.bottlenecks = {q: r.get("bottleneck") or {}
                               for q, r in queries.items()}
        except Exception:  # noqa: BLE001 — observation must never throw
            sig.bottlenecks = {}
    for qname, qr in app_runtime.query_runtimes.items():
        eng = getattr(qr, "engine", None)
        if eng is not None and hasattr(eng, "shrink_candidates"):
            try:
                cands = eng.shrink_candidates()
            except Exception:  # noqa: BLE001 — host occupancy read only
                cands = {}
            if cands:
                sig.join_shrinkable[qname] = cands
        layout = getattr(qr, "_route_layout", None)
        if layout is not None:
            sig.routed[qname] = int(layout.n)
    sig.fused_groups = len(app_runtime.fused_fanout_groups)
    return sig
