"""The declared actuator registry: every live knob the autopilot may
touch, with its typed-knob name and hard bounds.

Counterpart of ``siddhi_tpu/autopilot/actuators.py``: the same six
actuators, bounds and ``doc`` strings. Every ``apply`` keeps WHAT the
engine emits; it changes only when or where work runs:

- ``pipeline_depth``  a plain attribute write: the ``CompletionPump``
                      reads ``app_context.pipeline_depth`` at every submit
                      (``core/query/completion.py``), and a captured step's
                      staging ring grows a slot at the next put, each slot
                      reused only once its copies have completed;
- ``ingest_pool``     ``IngestPackPool.resize`` (the ordered merge keeps
                      the sub-batch sequence authoritative);
- ``join_partitions`` the join engine's Wp shrink through its directory
                      rebuild (``DeviceJoinEngine.shrink_partitions``);
- ``route_shards``    a re-install over another count of logical shards
                      on the same card: ``flush_owner``, then
                      ``device_route_query_step`` on the routed runtime,
                      which lays the canonical state out again and frees
                      the step it replaces;
- ``admission_cap``   writes the live ``OverloadConfig.queue_quota``;
- ``fuse_fanout``     dissolves or re-forms fused fan-out groups, deferred
                      to a batch boundary on the delivering thread.

``route_shards`` is capped by the ``siddhi_tpu.route_shards`` knob, else
by ``DEFAULT_ROUTE_SHARDS``. The port routes over logical shards side by
side on one card (``parallel/mesh.py``), so the card count is no cap;
the default is the shard count the reference reaches under its test
harness (its 8 virtual CPU devices).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

# direction spellings used across policy, decision log and telemetry
UP, DOWN = "up", "down"

# route_shards' cap when the knob is unset (see the module doc)
DEFAULT_ROUTE_SHARDS = 8


@dataclass(frozen=True)
class Actuator:
    """One declared actuation path.

    ``knob`` is the governing typed-knob key in ``core/util/knobs.py``.
    ``lo``/``hi`` are hard value bounds the policy may never push past.
    ``apply(rt, direction)`` returns ``(old, new)`` when it changed
    something, None when the actuation does not apply to this runtime
    (nothing to log)."""

    name: str
    knob: str
    lo: int
    hi: int
    doc: str
    apply: Optional[Callable] = None


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, v))


def _apply_pipeline_depth(rt, direction) -> Optional[Tuple[int, int]]:
    ctx = rt.app_context
    old = int(getattr(ctx, "pipeline_depth", 1) or 1)
    new = _clamp(old + (1 if direction == UP else -1), 1, 8)
    if new == old:
        return None
    # in-flight batches drain at the old depth; the next submit sees new
    ctx.pipeline_depth = new
    return old, new


def _apply_ingest_pool(rt, direction) -> Optional[Tuple[int, int]]:
    ctx = rt.app_context
    pool = ctx.ingest_pack_pool
    old = int(pool.workers) if pool is not None else 0
    new = _clamp(old + (1 if direction == UP else -1), 0, 8)
    if new == old:
        return None
    if pool is None:
        # the pool from zero: what start() builds
        from siddhi_tpu_torch.core.stream.input.pack_pool import IngestPackPool

        ctx.ingest_pack_pool = IngestPackPool(
            ctx, workers=new, split_rows=ctx.ingest_split)
    elif new == 0:
        # the pool to zero: a concurrent run_ordered that meets the
        # shutdown packs its sub-batches inline (the same ids and bytes)
        pool.shutdown()
        ctx.ingest_pack_pool = None
    else:
        pool.resize(new)
    ctx.ingest_pool = new
    return old, new


def _apply_join_partitions(rt, direction) -> Optional[Tuple[int, int]]:
    """Shrink only: Wp growth stays where it is (the engine grows before
    a batch dispatches the moment occupancy demands it); the autopilot
    releases over-provisioned sub-windows after a skew burst passes."""
    if direction != DOWN:
        return None
    changed = None
    for qr in rt.query_runtimes.values():
        eng = getattr(qr, "engine", None)
        if eng is None or not hasattr(eng, "shrink_partitions"):
            continue
        with qr._lock:   # no batch mid-step while the directory rebuilds
            rt.app_context.completion_pump.flush_owner(qr)
            shrunk = eng.shrink_partitions()
        for _side, (old_wp, new_wp) in (shrunk or {}).items():
            changed = (old_wp, new_wp) if changed is None else \
                (max(changed[0], old_wp), max(changed[1], new_wp))
    return changed


def _apply_route_shards(rt, direction) -> Optional[Tuple[int, int]]:
    from siddhi_tpu_torch.parallel.mesh import (
        device_route_query_step, make_mesh, route_ineligibility)

    cap = int(getattr(rt.app_context, "route_shards", 0) or 0) \
        or DEFAULT_ROUTE_SHARDS
    changed = None
    for qr in rt.query_runtimes.values():
        layout = getattr(qr, "_route_layout", None)
        if layout is None or route_ineligibility(qr) is not None:
            continue   # never routes an unrouted query: installing is a
            # deployment decision, the autopilot only re-sizes
        old = int(layout.n)
        new = old * 2 if direction == UP else old // 2
        if new < 2 or new > cap or new == old:
            continue
        with qr._lock:
            # drain this owner's pipelined batches so the canonical state
            # is settled before it is laid out again
            rt.app_context.completion_pump.flush_owner(qr)
            device_route_query_step(
                qr, make_mesh(new), rows_per_shard=layout.rows_per_shard,
                exchange=layout.exchange)
        changed = (old, new)
    return changed


def _apply_admission_cap(rt, direction) -> Optional[Tuple[int, int]]:
    ctl = rt.app_context.overload
    if ctl is None or ctl.config.queue_quota is None:
        return None   # no quotas armed: nothing to cap
    old = int(ctl.config.queue_quota)
    new = _clamp(old * 2 if direction == UP else old // 2, 16, 1 << 20)
    if new == old:
        return None
    # admit() reads the config per call and the quota gauges divide by
    # it, so /metrics follows the new cap at once
    ctl.config.queue_quota = new
    return old, new


def _apply_fuse_fanout(rt, direction) -> Optional[Tuple[int, int]]:
    from siddhi_tpu_torch.core.plan.fanout_plan import plan_junction_groups

    ctx = rt.app_context
    target = direction == UP
    old_n = len(rt.fused_fanout_groups)
    if target and old_n > 0:
        return None          # already fused
    if not target and old_n == 0 and not ctx.fuse_fanout:
        return None          # already dissolved
    ctx.fuse_fanout = target

    def _refit(junction):
        # runs ON the delivering thread at a batch boundary (the junction
        # drains deferred mutations before it fans a batch out), so the
        # receiver list is never rewired mid-delivery
        for g in [g for g in list(rt.fused_fanout_groups)
                  if g.junction is junction]:
            g.dissolve()
            try:
                rt.fused_fanout_groups.remove(g)
            except ValueError:
                pass
        if target:
            rt.fused_fanout_groups.extend(plan_junction_groups(junction))

    junctions = {g.junction for g in rt.fused_fanout_groups} if not target \
        else set(rt.junctions.values())
    for j in junctions:
        j.defer_mutation(lambda jn=j: _refit(jn))
    return (old_n, 0) if not target else (0, 1)


def _declare(*actuators: Actuator) -> Dict[str, Actuator]:
    return {a.name: a for a in actuators}


ACTUATORS: Dict[str, Actuator] = _declare(
    Actuator(name="pipeline_depth", knob="pipeline_depth", lo=1, hi=8,
             doc="CompletionPump overlap depth (live attr read)",
             apply=_apply_pipeline_depth),
    Actuator(name="ingest_pool", knob="ingest_pool", lo=0, hi=8,
             doc="IngestPackPool worker count (ordered-merge resize)",
             apply=_apply_ingest_pool),
    Actuator(name="join_partitions", knob="join_partition_slack", lo=1,
             hi=64,
             doc="device-join Wp shrink (growth stays in prepare_batch)",
             apply=_apply_join_partitions),
    Actuator(name="route_shards", knob="route_shards", lo=2, hi=64,
             doc="routed shard count (canonical blue/green re-install)",
             apply=_apply_route_shards),
    Actuator(name="admission_cap", knob="quota_queue_depth", lo=16,
             hi=1 << 20,
             doc="live OverloadConfig queue quota",
             apply=_apply_admission_cap),
    Actuator(name="fuse_fanout", knob="fuse_fanout", lo=0, hi=1,
             doc="fan-out fusion dissolve/re-form at a batch boundary",
             apply=_apply_fuse_fanout),
)
