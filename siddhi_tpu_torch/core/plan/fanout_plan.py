"""Fan-out fusion planning: which sibling queries of one junction may fuse.

Counterpart of ``siddhi_tpu/core/plan/fanout_plan.py``. The shared scan
is the junction's packed columnar batch and the shared computation is ONE
step covering every sibling query (``core/query/fused_fanout.py``): N
queries subscribed to one stream pay one dispatch (on the card, one CUDA
graph replay) and one ``__meta__`` round trip per batch instead of N of
each. This module decides WHICH subscribers may join a fused group;
everything else keeps its own delivery unchanged.

Eligibility (``fusion_ineligibility`` returns the reason for the first
miss, or None):

- a plain single-stream ``QueryRuntime``, or a device-engine join side
  (``JoinSideProxy``, which owns its own rules). Pattern and sequence
  runtimes subscribe proxies of another class, and joins without the
  engine are refused by their proxy: neither fuses;
- not partitioned (per-key flows carry the pk protocol the group does
  not);
- device-only: no host window, no host-side transform chain, no #log
  taps (all three run host stages per member between pack and step);
- no scheduler-driven window (time, timeBatch, ... windows need their
  per-batch wake time handled through their own timer re-entry);
- not routed over a mesh (``parallel/mesh.py`` owns that step; routing an
  already-fused member releases it from its group).

Groups are formed from CONTIGUOUS runs of eligible receivers, so delivery
order relative to every other subscriber (stream callbacks, sinks,
aggregations) is exactly the unfused subscription order, and the members
of one group emit in their subscription order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from siddhi_tpu_torch.query_api.expressions import Variable


def fusion_ineligibility(q) -> Optional[str]:
    """Why ``q`` cannot join a fused fan-out group (None = eligible, else
    a ``core.eligibility.Reason``: its text and a stable ``.code``)."""
    from siddhi_tpu_torch.core.eligibility import ReasonCode as RC
    from siddhi_tpu_torch.core.eligibility import reason
    from siddhi_tpu_torch.core.query.join_runtime import JoinSideProxy
    from siddhi_tpu_torch.core.query.runtime import QueryRuntime

    if isinstance(q, JoinSideProxy):
        return q.fusion_ineligibility()
    if type(q) is not QueryRuntime:
        return reason(RC.NOT_PLAIN_RUNTIME,
                      f"not a plain single-stream runtime ({type(q).__name__})")
    if q.partition_ctx is not None:
        return reason(RC.PARTITIONED, "partitioned")
    if q.host_window is not None:
        return reason(RC.HOST_WINDOW, "host-mode window")
    if q.host_transforms:
        return reason(RC.HOST_TRANSFORM, "host-side transform chain")
    if q.log_stages:
        return reason(RC.LOG_TAPS, "#log() host taps")
    if q.window_stage is not None and getattr(
            q.window_stage, "needs_scheduler", False):
        return reason(RC.SCHEDULER_WINDOW, "scheduler-driven window")
    if q._route_layout is not None:
        return reason(RC.SHARDED, "routed over a mesh")
    return None


def keyer_signature(q) -> Optional[Tuple]:
    """Identity of a query's group-key computation, used to share one
    ``GroupKeyer`` inside a fused group (the common ``group by symbol``
    fan-out runs the keyer ONCE for the whole group). Only plain attribute
    references are comparable; anything else returns None (never
    shared)."""
    if q.keyer is None:
        return ()
    sig = []
    for var in q.selector_plan.group_key_exprs:
        if type(var) is not Variable:
            return None
        sig.append((var.attribute_name, var.stream_id))
    return tuple(sig)


def plan_junction_groups(junction) -> List:
    """Group ONE junction's contiguous runs of eligible sibling queries
    into ``FusedFanoutRuntime``s, wired in place of the members in the
    junction's receiver list."""
    from siddhi_tpu_torch.core.query.fused_fanout import FusedFanoutRuntime

    groups: List = []
    run: List = []

    def close_run():
        if len(run) >= 2:
            groups.append(FusedFanoutRuntime(junction, list(run)))
        run.clear()

    for r in list(junction.receivers):
        if fusion_ineligibility(r) is None:
            run.append(r)
        else:
            close_run()
    close_run()
    return groups


def plan_fanout_groups(app_runtime) -> List:
    """Group each junction's contiguous runs of eligible sibling queries
    into ``FusedFanoutRuntime``s. Returns the groups; honours the
    ``siddhi_tpu.fuse_fanout`` knob (on by default)."""
    groups: List = []
    if not getattr(app_runtime.app_context, "fuse_fanout", True):
        return groups
    for junction in app_runtime.junctions.values():
        groups.extend(plan_junction_groups(junction))
    return groups
