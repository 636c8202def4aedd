"""The partitioned join engine (see ``engine.py``).

``attach_join_engine`` is the planner's one hook: it classifies a freshly
built ``JoinQueryRuntime`` (engine-eligible, pipeline-eligible, or the
broadcast probe), records the reasons on it and attaches the engine to
the eligible shapes, with the join's metrics: the per-query
``join.probe_ms.<q>``/``join.insert_ms.<q>`` histograms (recorded by
``process_side_batch``) and the ``join.partition_rows.<q>.<side>.<p>``
gauges, which read ``partition_occupancy`` (no device read).
"""

from __future__ import annotations

from siddhi_tpu_torch.core.join.engine import (  # noqa: F401 — public surface
    ENGINE_STATE_KEYS,
    PIDX_KEYS,
    SEQ_KEY,
    DeviceJoinEngine,
    engine_ineligibility,
    extract_partition_keys,
    hash_partition_dev,
    hash_partition_np,
    pipeline_ineligibility,
)


def attach_join_engine(rt, on_expr) -> None:
    """Classify ``rt`` and attach the engine when it is eligible. With
    ``siddhi_tpu.join_engine`` = ``legacy`` the runtime keeps the
    synchronous broadcast probe wholesale (the baseline the engine is held
    equal to)."""
    from siddhi_tpu_torch.core.eligibility import ReasonCode as RC
    from siddhi_tpu_torch.core.eligibility import reason

    rt.engine = None
    rt.engine_reason = engine_ineligibility(rt)
    rt.pipeline_reason = pipeline_ineligibility(rt)
    mode = str(getattr(rt.app_context, "join_engine", "device") or "device")
    if mode != "device":
        rt.engine_reason = rt.engine_reason or reason(
            RC.DISABLED, "disabled (siddhi_tpu.join_engine=legacy)")
        rt.pipeline_reason = reason(RC.DISABLED, "siddhi_tpu.join_engine=legacy")
        return
    if rt.engine_reason is not None:
        return
    pspec = (extract_partition_keys(on_expr, rt.sides["left"], rt.sides["right"],
                                    rt.dictionary)
             if on_expr is not None else None)
    rt.engine = DeviceJoinEngine(rt, pspec)
    rt._instr_spec = None   # the engine's suffix (seq, fills) joins the spec
    _register_metrics(rt)


def _register_metrics(rt) -> None:
    tel = rt.app_context.telemetry
    # the probe and insert histograms exist from the app's start, so their
    # families are on /metrics before the first batch
    tel.histogram(f"join.probe_ms.{rt.name}")
    tel.histogram(f"join.insert_ms.{rt.name}")
    eng = rt.engine
    for side_key, plan in eng.plans.items():
        if not plan.use_pidx:
            continue
        for p in range(eng.P):
            tel.gauge(f"join.partition_rows.{rt.name}.{side_key}.{p}",
                      lambda e=eng, s=side_key, i=p: float(e.partition_occupancy(s)[i]))
