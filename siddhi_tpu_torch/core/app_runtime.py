"""SiddhiAppRuntime: one assembled app — junctions, queries, callbacks.

Counterpart of ``siddhi_tpu/core/app_runtime.py``, reduced to what the
port runs: stream definitions, queries, value and range partitions (with
inner ``#streams``, partition-local streams and ``@purge``), stream and
query callbacks, custom extension functions and ``define function``
scripts, the set-element metadata of OBJECT attributes,
``@app:name``/``@app:playback`` (with its idle heartbeat)/
``@app:precision``, the app's scheduler (TIMER chunks of time windows),
output rate limiters, pattern and sequence queries (one proxy receiver
per consumed stream), joins (one proxy receiver per side), tables with
``insert into``/``delete``/``update``/``update or insert into`` and ``in
<table>``, named windows, triggers, on-demand queries
(``SiddhiAppRuntime.query``), ``@Async`` and ``@OnError`` streams,
``@source``/``@sink`` transports, the dispatch pipeline and the ingest
pack pool, the ``siddhi_tpu.*`` config knobs, incremental aggregations
(``define aggregation``, with their ``@purge`` schedule), and the
persistence API (``persist``, ``persist_incremental``,
``restore_revision``, ``restore_last_revision``, ``clear_all_revisions``,
``snapshot``, ``restore``: ``core/util/snapshot.py``), the serving
tier's sharded aggregation stores (``siddhi_tpu.agg_shards`` > 1,
``serving/``), ``@app:statistics`` (``statistics()``,
``set_statistics_level``, the console reporter), ``@app:enforceOrder``,
the ingest WAL (``enable_wal``), the debugger (``debug()``,
``core/debugger.py``; it dissolves the app's fused groups first) and the
device profiler trace (``start_trace``/``stop_trace``,
``observability/device_trace.py``). What the port lacks raises naming
itself, so an app never runs with a part silently missing.

The app starts at ``start()`` or at its first send: @Async workers, the
ingest pool, rate limiters, sinks' connections and sources (each
connecting with retry on its own thread); its knobs
``siddhi_tpu.profile_journeys``, ``profile_costs`` and
``profile_device_instruments`` each take one ref on their process-wide
collector until ``shutdown``; with ``siddhi_tpu.autopilot`` armed (or
``enable_autopilot``) the app registers with the process-wide autopilot
controller (``autopilot/``), which ``shutdown`` detaches first. ``shutdown`` stops the
heartbeat, drains the pipeline, stops sources, limiters and workers (each
delivers what its queue holds first), stops the scheduler, then drops the
device state.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from siddhi_tpu_torch.analysis.locks import make_lock
from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException
from siddhi_tpu_torch.core.context import SiddhiAppContext, SiddhiContext
from siddhi_tpu_torch.core.plan.query_planner import plan_query
from siddhi_tpu_torch.core.query.callback import QueryCallback
from siddhi_tpu_torch.core.query.ratelimit import (create_rate_limiter,
                                                    rate_uses_group_key)
from siddhi_tpu_torch.core.query.runtime import QueryRuntime
from siddhi_tpu_torch.core.stream.input.input_handler import InputHandler, InputManager
from siddhi_tpu_torch.core.stream.junction import StreamJunction
from siddhi_tpu_torch.core.stream.output.stream_callback import StreamCallback
from siddhi_tpu_torch.core.util.scheduler import Scheduler
from siddhi_tpu_torch.observability.tracing import span
from siddhi_tpu_torch.ops.expressions import CompileError, set_active_extensions
from siddhi_tpu_torch.query_api.annotations import find_annotation, find_annotations
from siddhi_tpu_torch.query_api.definitions import Attribute, AttrType, StreamDefinition
from siddhi_tpu_torch.query_api.execution import (
    DeleteStream,
    EventTrigger,
    InsertIntoStream,
    JoinInputStream,
    Partition,
    Query,
    RangePartitionType,
    SingleInputStream,
    StateInputStream,
    UpdateOrInsertStream,
    UpdateStream,
    ValuePartitionType,
)
from siddhi_tpu_torch.query_api.expressions import AttributeFunction, Variable
from siddhi_tpu_torch.query_api.siddhi_app import SiddhiApp


def _compile_script_function(fdef):
    """``define function f[python] return <type> { <expression> }``: the
    body is a Python expression over ``arg0..argN`` (also ``data0..``)
    with ``xp`` (the port's array namespace, ``ops/expressions.TorchXP``
    in a step) and ``np`` in scope, evaluated once per batch over whole
    columns (the reference's ScriptFunctionExecutor runs per event).
    String arguments arrive dictionary-encoded."""
    if fdef.language.lower() not in ("python", "py"):
        raise CompileError(
            f"function '{fdef.id}': script language '{fdef.language}' is not "
            f"supported (use [python])")
    import numpy as _np

    code = compile(fdef.body.strip(), f"<function {fdef.id}>", "eval")
    rtype = fdef.return_type

    class _Script:
        return_type = rtype

        @staticmethod
        def apply(xp, *args):
            ns = {"xp": xp, "np": _np}
            for i, a in enumerate(args):
                ns[f"arg{i}"] = a
                ns[f"data{i}"] = a
            return eval(code, ns)  # noqa: S307 — user-defined app function

    return _Script


def _parse_time_ms(s: str) -> float:
    """'5 ms' / '1 sec' / '250' -> milliseconds (@Async max.delay and
    latency.target)."""
    from siddhi_tpu_torch.compiler.tokenizer import _TIME_UNIT_MS

    parts = s.strip().lower().split()
    if len(parts) == 2 and parts[1] in _TIME_UNIT_MS:
        return float(parts[0]) * _TIME_UNIT_MS[parts[1]]
    if len(parts) == 1 and parts[0].replace(".", "", 1).isdigit():
        return float(parts[0])
    raise SiddhiAppValidationException(f"cannot parse time '{s}'")


def _parse_playback_time(s: str, what: str) -> int:
    """Strict time constant of an @app:playback element: '<int> <unit>'
    pairs only; a bare number or an empty string fails app creation, as
    the reference's SiddhiCompiler.parseTimeConstantDefinition does."""
    from siddhi_tpu_torch.compiler.errors import SiddhiParserException
    from siddhi_tpu_torch.compiler.tokenizer import is_time_unit, time_unit_ms

    parts = (s or "").split()
    if not parts or len(parts) % 2 != 0:
        raise SiddhiParserException(
            f"Invalid {what} constant '{s}' in playback annotation")
    total = 0
    for num, unit in zip(parts[::2], parts[1::2]):
        if not num.isdigit() or not is_time_unit(unit.lower()):
            raise SiddhiParserException(
                f"Invalid {what} constant '{s}' in playback annotation")
        total += int(num) * time_unit_ms(unit.lower())
    return total


_PURGE_UNITS_MS = {
    "ms": 1, "millisecond": 1, "milliseconds": 1,
    "sec": 1000, "second": 1000, "seconds": 1000,
    "min": 60_000, "minute": 60_000, "minutes": 60_000,
    "h": 3600_000, "hour": 3600_000, "hours": 3600_000,
    "day": 86_400_000, "days": 86_400_000,
    "month": 31 * 86_400_000, "months": 31 * 86_400_000,
    "year": 366 * 86_400_000, "years": 366 * 86_400_000,
}


def _parse_purge_time(s: str) -> int:
    """``@purge`` interval / idle.period: '10 sec', '1 hour' or a bare
    number of milliseconds (the reference's retention-time parser)."""
    s = s.strip().lower()
    parts = s.split()
    if len(parts) == 2 and parts[1] in _PURGE_UNITS_MS:
        return int(float(parts[0]) * _PURGE_UNITS_MS[parts[1]])
    if s.isdigit():
        return int(s)
    raise CompileError(f"cannot parse retention/interval time '{s}'")


def _default_app_name(siddhi_app: SiddhiApp) -> str:
    import hashlib

    return "siddhi-app-" + hashlib.md5(repr(siddhi_app).encode()).hexdigest()[:12]


class SiddhiAppRuntime:  # graftlint: disable=R8 — the junction/query/
    # adapter registries are populated during single-threaded wiring
    # (parse + add_callback before start()); runtime threads only read
    # them, and lifecycle transitions serialize on the app barrier
    def __init__(self, siddhi_app: SiddhiApp, siddhi_context: SiddhiContext):
        self.siddhi_app = siddhi_app
        self.name = siddhi_app.name or _default_app_name(siddhi_app)
        self.app_context = SiddhiAppContext(siddhi_context, self.name)
        self._barrier = make_lock("barrier")
        self.app_context.timestamp_generator.set_heartbeat_barrier(self._barrier)
        self.stream_definitions: Dict[str, StreamDefinition] = dict(
            siddhi_app.stream_definitions)
        self.junctions: Dict[str, StreamJunction] = {}
        self.query_runtimes: Dict[str, QueryRuntime] = {}
        self.partition_contexts: List = []
        self.source_runtimes: List = []
        self.sink_runtimes: List = []
        self._started = False
        self._costs_on = False     # holds one costmodel.enable()
        self._journeys_on = False  # holds one journey.enable()
        self._instruments_on = False  # holds one instruments.enable()
        self._tracing = False      # this app started the device trace
        self._debugger = None

        pb = siddhi_app.app_annotation("playback")
        if pb is not None:
            # idle.time + increment enable the idle heartbeat
            # (reference SiddhiAppParser.java:171-212)
            self.app_context.playback = True
            self.app_context.timestamp_generator.playback = True
            elems = pb.elements_map()
            unknown = [k for k in elems if k not in ("idle.time", "increment")]
            if unknown:
                raise SiddhiAppValidationException(
                    "Playback annotation accepts only idle.time and "
                    f"increment but found {unknown[0]}")
            idle_s, inc_s = elems.get("idle.time"), elems.get("increment")
            if (idle_s is None) != (inc_s is None):
                raise SiddhiAppValidationException(
                    "Playback annotation requires both idle.time and "
                    "increment when either is given")
            if idle_s is not None:
                self.app_context.timestamp_generator.configure_heartbeat(
                    _parse_playback_time(idle_s, "idle.time"),
                    _parse_playback_time(inc_s, "increment"))
        if siddhi_app.app_annotation("enforceOrder") is not None:
            self.app_context.enforce_order = True
        if siddhi_app.app_annotation("async") is not None:
            # reference SiddhiAppParser.java:105-111: @Async is a stream
            # annotation; the app-level form fails creation
            raise SiddhiAppValidationException(
                "@Async not supported in SiddhiApp level, instead use "
                "@Async with streams")
        prec = siddhi_app.app_annotation("precision")
        if prec is not None:
            v = (prec.element() or "").lower()
            if v not in ("exact", "fast"):
                raise SiddhiAppValidationException(
                    "@app:precision must be 'exact' or 'fast'")
            self.app_context.precision = v
        self.app_context.scheduler = Scheduler(self.app_context)
        self._configure_statistics(siddhi_app)

        # deployment config: every siddhi_tpu.* key resolves through the
        # typed knob registry (junk spellings raise naming the key)
        from siddhi_tpu_torch.core.util.knobs import apply_app_knobs

        explicit = apply_app_knobs(siddhi_context.config_manager, self.app_context)
        if self.app_context.defer_meta > 1:
            self._map_defer_meta(explicit.get("pipeline_depth"))

        # the manager's extensions and this app's `define function` scripts
        # are the registry every query of the app compiles against
        self._extensions = {
            **siddhi_context.extensions,
            **{f"function:{fid}": _compile_script_function(fdef)
               for fid, fdef in siddhi_app.function_definitions.items()}}
        set_active_extensions(self._extensions)

        for sdef in list(self.stream_definitions.values()):
            self._create_junction(sdef)
        self._define_stores(siddhi_app, siddhi_context)

        self.input_manager = InputManager(self.app_context, self.junctions,
                                          self._barrier)
        self.input_manager.ensure_started = self.start

        # set metadata of explicitly defined target streams first, so a
        # consumer query written before its producer compiles with it
        self._prescan_object_metadata(siddhi_app)
        q_index = 0
        p_index = 0
        for element in siddhi_app.execution_elements:
            if isinstance(element, Query):
                q_index += 1
                self._add_query(element, q_index)
            elif isinstance(element, Partition):
                p_index += 1
                q_index = self._add_partition(element, p_index, q_index)

        # transport boundary: @source / @sink stream annotations
        from siddhi_tpu_torch.core.stream.input.source import create_source_runtime
        from siddhi_tpu_torch.core.stream.output.sink import create_sink_runtime

        extensions = siddhi_context.extensions
        for sid, sdef in list(self.stream_definitions.items()):
            for ann in find_annotations(sdef.annotations or [], "source"):
                self.source_runtimes.append(create_source_runtime(
                    ann, sdef, self.get_input_handler(sid), self.app_context,
                    extensions))
            for ann in find_annotations(sdef.annotations or [], "sink"):
                sr = create_sink_runtime(ann, sdef, self.app_context, extensions)
                self.junctions[sid].subscribe(sr)
                self.sink_runtimes.append(sr)

        # fan-out fusion: contiguous runs of sibling queries on one junction
        # fuse into ONE step and ONE meta pull a batch, on the card one CUDA
        # graph replay (core/plan/fanout_plan.py); siddhi_tpu.fuse_fanout
        # turns it off
        from siddhi_tpu_torch.core.plan.fanout_plan import plan_fanout_groups

        self.fused_fanout_groups: List = plan_fanout_groups(self)

        # eligibility census (core/eligibility.py): every query classified
        # on every strategy surface (route / fusion / join engine / join
        # pipeline) with stable reason codes, kept on
        # self.eligibility_census for tooling (the semantic fuzzer) and
        # counted as the siddhi_eligibility_total{surface,code,query}
        # family on /metrics
        from siddhi_tpu_torch.core.eligibility import register_census

        register_census(self)

        # overload control (resilience/overload.py): the siddhi_tpu.quota_*
        # and siddhi_tpu.shed_policy keys register per-app queue quotas,
        # shed policies, the pipeline quota, a device-memory budget and a
        # fair-share weight. No key set: app_context.overload stays None
        cm = siddhi_context.config_manager
        if cm is not None:
            self._overload_from_config(cm)

    def _overload_from_config(self, cm) -> None:
        from siddhi_tpu_torch.core.util.knobs import read_knob

        queue_quota = read_knob(cm, "quota_queue_depth")
        policy = read_knob(cm, "shed_policy")
        pipeline_quota = read_knob(cm, "quota_pipeline_depth")
        memory_mb = read_knob(cm, "quota_memory_mb")
        block_timeout = read_knob(cm, "quota_block_timeout_s")
        fair_weight = read_knob(cm, "fair_weight")
        query_cap = read_knob(cm, "quota_query_cap")
        per_stream_quota = {}
        per_stream_policy = {}
        for sid in self.junctions:
            v = read_knob(cm, "quota_queue_depth", stream=sid)
            if v is not None:
                per_stream_quota[sid] = v
            v = read_knob(cm, "shed_policy", stream=sid)
            if v is not None:
                per_stream_policy[sid] = v
        # presence, not truthiness: an explicit quota_queue_depth of 0 or
        # fair_weight of 0 still registers
        if all(v is None for v in (queue_quota, policy, pipeline_quota,
                                   memory_mb, block_timeout, fair_weight,
                                   query_cap)) \
                and not per_stream_quota and not per_stream_policy:
            return
        self.enable_overload(
            queue_quota=queue_quota,
            shed_policy=policy if policy else "block",
            queue_quota_per_stream=per_stream_quota,
            shed_policy_per_stream=per_stream_policy,
            pipeline_quota=pipeline_quota,
            memory_budget_mb=memory_mb,
            block_timeout_s=block_timeout,
            fair_weight=fair_weight if fair_weight is not None else 1.0,
            query_cap=query_cap)

    def enable_overload(self, queue_quota=None, shed_policy="block",
                        queue_quota_per_stream=None,
                        shed_policy_per_stream=None, pipeline_quota=None,
                        memory_budget_mb=None, block_timeout_s=None,
                        fair_weight=1.0, query_cap=None):
        """Register this app with the process's overload layer
        (``resilience/overload.py``): @Async queue quotas with per-stream
        ``block`` / ``shed_oldest`` / ``shed_newest`` policies, an app-wide
        pipeline quota, an approximate device-memory budget gating every
        capacity-growth site, and a weighted fair share against sibling
        apps. A second call replaces the config; returns the
        ``AppOverloadControl``."""
        from siddhi_tpu_torch.resilience.overload import (
            DEFAULT_BLOCK_TIMEOUT_S,
            OverloadConfig,
            OverloadManager,
        )

        cfg = OverloadConfig(
            queue_quota=queue_quota,
            queue_quota_per_stream=dict(queue_quota_per_stream or {}),
            shed_policy=shed_policy or "block",
            shed_policy_per_stream=dict(shed_policy_per_stream or {}),
            pipeline_quota=pipeline_quota,
            memory_budget_bytes=(int(memory_budget_mb * 1024 * 1024)
                                 if memory_budget_mb is not None else None),
            block_timeout_s=(block_timeout_s if block_timeout_s is not None
                             else DEFAULT_BLOCK_TIMEOUT_S),
            fair_weight=fair_weight,
            query_cap=query_cap)
        return OverloadManager.instance().register(self, cfg)

    # ------------------------------------------------------------ assembly

    def _configure_statistics(self, siddhi_app: SiddhiApp) -> None:
        """``@app:statistics('true')`` or ``@app:statistics(level='detail',
        reporter='console', interval='5 sec')`` (reference
        SiddhiStatisticsManager wiring)."""
        ann = siddhi_app.app_annotation("statistics")
        if ann is None:
            return
        from siddhi_tpu_torch.core.aggregation.incremental import _parse_time_str
        from siddhi_tpu_torch.core.util.statistics import StatisticsManager, parse_level

        interval = ann.element("interval")
        self.app_context.statistics_manager = StatisticsManager(
            level=parse_level(ann.element("level") or ann.element()),
            reporter=ann.element("reporter"),
            interval_ms=_parse_time_str(interval) if interval else 60_000)

    def _define_stores(self, siddhi_app: SiddhiApp, siddhi_context) -> None:
        """Tables, named windows and triggers (the reference's
        defineTable/defineWindow/defineTrigger at app assembly)."""
        from siddhi_tpu_torch.core.table.record_table import create_table
        from siddhi_tpu_torch.core.trigger import TriggerRuntime
        from siddhi_tpu_torch.core.window import NamedWindowRuntime

        ctx = self.app_context
        dictionary = ctx.string_dictionary
        self.tables = {tid: create_table(tdef, dictionary, siddhi_context.extensions,
                                         ctx.device)
                       for tid, tdef in siddhi_app.table_definitions.items()}
        for t in self.tables.values():
            # tables gate their capacity growth on the app's device-memory
            # budget (resilience/overload.py)
            t.app_context = ctx
            cache = getattr(t, "cache", None)
            if cache is not None:
                # a row cached before start() stamps the clock the expiry
                # sweep reads (wall time would make playback rows immortal)
                cache.now_fn = ctx.timestamp_generator.current_time
        self.named_windows = {}
        for wid, wdef in siddhi_app.window_definitions.items():
            w = NamedWindowRuntime(wdef, ctx, dictionary)
            w.scheduler = ctx.scheduler
            self.named_windows[wid] = w
        ctx.tables = self.tables
        ctx.named_windows = self.named_windows
        self._define_aggregations(siddhi_app, siddhi_context)
        self.trigger_runtimes = []
        for tid, tdef in siddhi_app.trigger_definitions.items():
            if tid in self.junctions:
                # an explicit `(triggered_time long)` stream may share the
                # trigger's id (TriggerTestCase testQuery4)
                junction = self.junctions[tid]
            else:
                sdef = StreamDefinition(
                    id=tid, attributes=[Attribute("triggered_time", AttrType.LONG)])
                self.stream_definitions[tid] = sdef
                junction = self._create_junction(sdef)
            self.trigger_runtimes.append(
                TriggerRuntime(tdef, junction, ctx, barrier=self._barrier))

    def _define_aggregations(self, siddhi_app: SiddhiApp, siddhi_context) -> None:
        """Incremental aggregations (reference AggregationParser and
        AggregationRuntime), each subscribed to its input junction.
        ``siddhi_tpu.agg_shards`` > 1 selects the serving tier's sharded
        stores (``serving/sharded_aggregation.py``); ``@PartitionById``
        (annotation or system property) keeps the store-stitched shard
        mode, as in the reference."""
        from siddhi_tpu_torch.core.aggregation import IncrementalAggregationRuntime

        ctx = self.app_context
        cm = siddhi_context.config_manager
        sys_pbi = ((cm.get_property("partitionById") or "")
                   if cm is not None else "").lower() == "true"
        n_shards = int(getattr(ctx, "agg_shards", 1) or 1)
        self.aggregations = {}
        for aid, adef in siddhi_app.aggregation_definitions.items():
            pbi = find_annotation(adef.annotations or [], "PartitionById")
            if n_shards > 1 and pbi is None and not sys_pbi:
                from siddhi_tpu_torch.serving import ShardedIncrementalAggregation

                agg = ShardedIncrementalAggregation(
                    adef, ctx, ctx.string_dictionary, self.stream_definitions,
                    n_shards=n_shards, wal_batches=ctx.agg_shard_wal or None)
            else:
                agg = IncrementalAggregationRuntime(
                    adef, ctx, ctx.string_dictionary, self.stream_definitions)
            self.junctions[agg.input_stream_id].subscribe(agg)
            self.aggregations[aid] = agg
        ctx.aggregations = self.aggregations

    def _map_defer_meta(self, explicit_depth) -> None:
        """``siddhi_tpu.defer_meta`` > 1 is deprecated: the dispatch
        pipeline subsumes it. Without an explicit ``pipeline_depth`` it
        becomes the depth; with one, the depth wins (the reference keeps
        defer_meta for its legacy hold-N path, which the port lacks)."""
        import warnings

        ctx = self.app_context
        if explicit_depth is None:
            warnings.warn(
                "siddhi_tpu.defer_meta is deprecated — use "
                "siddhi_tpu.pipeline_depth (the dispatch pipeline subsumes "
                f"meta-defer batching); mapping defer_meta={ctx.defer_meta} "
                "onto pipeline_depth", DeprecationWarning, stacklevel=3)
            ctx.pipeline_depth = max(ctx.pipeline_depth, ctx.defer_meta)
        else:
            warnings.warn(
                "siddhi_tpu.defer_meta is deprecated — use "
                f"siddhi_tpu.pipeline_depth; explicit pipeline_depth="
                f"{explicit_depth} wins over defer_meta={ctx.defer_meta}",
                DeprecationWarning, stacklevel=3)
        ctx.defer_meta = 1

    def _create_junction(self, sdef: StreamDefinition) -> StreamJunction:
        """The stream's junction, with ``@Async(buffer.size, batch.size,
        max.delay, latency.target)`` and ``@OnError(action='stream')``
        (a ``!S`` fault junction: S's attributes and ``_error``)."""
        j = StreamJunction(sdef, self.app_context)
        anns = sdef.annotations or []
        async_ann = find_annotation(anns, "async")
        if async_ann is not None:
            if self.app_context.enforce_order:
                raise SiddhiAppValidationException(
                    f"@app:enforceOrder is incompatible with @Async on "
                    f"stream '{sdef.id}': async buffering can interleave "
                    f"producer batches out of timestamp order")
            max_delay = async_ann.element("max.delay")
            latency_target = async_ann.element("latency.target")
            j.enable_async(
                int(async_ann.element("buffer.size") or 1024),
                int(async_ann.element("batch.size") or 256),
                max_delay_ms=_parse_time_ms(max_delay) if max_delay else None,
                latency_target_ms=(_parse_time_ms(latency_target)
                                   if latency_target else None))
        onerr = find_annotation(anns, "OnError")
        if onerr is not None and (onerr.element("action") or "log").lower() == "stream":
            fdef = StreamDefinition(
                id="!" + sdef.id,
                attributes=list(sdef.attributes) + [Attribute("_error", AttrType.STRING)])
            fj = StreamJunction(fdef, self.app_context)
            self.junctions[fdef.id] = fj
            self.stream_definitions[fdef.id] = fdef
            j.fault_junction = fj
            j.on_error_action = "STREAM"
        self.junctions[sdef.id] = j
        return j

    def _add_partition(self, partition: Partition, p_index: int, q_index: int) -> int:
        """Assemble a ``partition with (...) begin ... end`` block (the
        role of reference ``PartitionParser`` + ``PartitionRuntimeImpl``),
        with per-key processor instances replaced by dense keyed state
        (``ops/keyed_windows.py``)."""
        from siddhi_tpu_torch.core.partition import (
            PartitionContext,
            RangePartitionKeyer,
            ValuePartitionKeyer,
        )
        from siddhi_tpu_torch.core.plan.resolvers import SingleStreamResolver
        from siddhi_tpu_torch.ops.expressions import compile_condition, compile_expr

        pctx = PartitionContext(p_index)
        self.partition_contexts.append(pctx)
        purge_ann = find_annotation(partition.annotations or [], "purge")
        if purge_ann is not None and (
                purge_ann.element("enable") or "true").lower() == "true":
            interval = purge_ann.element("interval")
            idle = purge_ann.element("idle.period")
            pctx.purge_interval_ms = (_parse_purge_time(interval)
                                      if interval else 60_000)
            pctx.purge_idle_ms = _parse_purge_time(idle) if idle else 3600_000
            pctx.keyspace.enable_purge_tracking()
        for ptype in partition.partition_types:
            sid = ptype.stream_id
            if sid not in self.stream_definitions:
                raise SiddhiAppValidationException(
                    f"partition with (... of {sid}): stream '{sid}' is not defined")
            resolver = SingleStreamResolver(
                self.stream_definitions[sid], self.app_context.string_dictionary)
            if isinstance(ptype, ValuePartitionType):
                fn, t = compile_expr(ptype.expression, resolver)
                pctx.keyers[sid] = ValuePartitionKeyer([(fn, t)], pctx.keyspace)
            elif isinstance(ptype, RangePartitionType):
                pctx.keyers[sid] = RangePartitionKeyer([
                    (rc.partition_key, compile_condition(rc.condition, resolver))
                    for rc in ptype.conditions])
            else:
                raise SiddhiAppValidationException(f"unknown partition type {ptype!r}")

        # streams produced by queries inside this partition (non-inner insert
        # targets) that a partition-mate consumes: their rows stay in the
        # producing instance's flow, so they carry its pk (reference
        # partition flow ids; WindowPartitionTestCase q6 chains `insert
        # events into OutputStream` -> `from OutputStream`)
        produced = {
            q.output_stream.target_id for q in partition.queries
            if isinstance(q.output_stream, InsertIntoStream)
            and not q.output_stream.is_inner_stream}
        consumed = set()
        for q in partition.queries:
            ist = q.input_stream
            for attr in ("stream_id", "unique_stream_id"):
                sid = getattr(ist, attr, None)
                if isinstance(sid, str):
                    consumed.add(sid)
        pctx.local_streams = produced & consumed
        for query in partition.queries:
            q_index += 1
            self._add_query(query, q_index, partition_ctx=pctx)
        return q_index

    def _add_query(self, query: Query, index: int, partition_ctx=None):
        query_name = query.name or f"query_{index}"
        definitions = dict(self.stream_definitions)
        for wid, w in self.named_windows.items():
            definitions[wid] = w.definition
        for tid, t in self.tables.items():
            definitions[tid] = t.definition
        if partition_ctx is not None:
            definitions.update(partition_ctx.inner_definitions)
        if (isinstance(query.input_stream, SingleInputStream)
                and query.input_stream.unique_stream_id in self.tables):
            raise SiddhiAppValidationException(
                f"'{query.input_stream.stream_id}' is a table — consume it via a "
                f"join or an on-demand query (runtime.query(...))")
        with span("plan", query=query_name):
            runtime = plan_query(query, query_name, self.app_context, definitions,
                                 partition_ctx=partition_ctx)
        runtime.query_ast = query   # fan-out fusion's program signature reads it
        self._wire_output(query, query_name, runtime, partition_ctx)
        self._attach_rate_limiter(query, runtime, partition_ctx)
        ist = query.input_stream
        if isinstance(ist, StateInputStream):
            # pattern/sequence: one proxy receiver per consumed stream
            for sid, proxy in runtime.make_proxies().items():
                self.junctions[sid].subscribe(proxy)
        elif isinstance(ist, JoinInputStream):
            self._subscribe_join(ist, runtime, partition_ctx)
        else:
            in_id = ist.unique_stream_id
            if partition_ctx is not None and ist.is_inner_stream:
                if in_id not in partition_ctx.inner_junctions:
                    raise SiddhiAppValidationException(
                        f"inner stream '{in_id}' is consumed before any query "
                        f"in this partition produces it")
                partition_ctx.inner_junctions[in_id].subscribe(runtime)
            elif in_id in self.named_windows:
                # `from W`: the named window's emissions
                self.named_windows[in_id].out_junction.subscribe(runtime)
            else:
                self.junctions[in_id].subscribe(runtime)
        self.query_runtimes[query_name] = runtime
        if partition_ctx is not None:
            partition_ctx.runtimes.append(runtime)

    def _subscribe_join(self, ist: JoinInputStream, runtime, partition_ctx) -> None:
        """A join's side receivers: a table side has none, a named-window
        side takes the window's emissions, a stream side its junction."""
        proxies = runtime.make_proxies()
        for side_key, s in (("left", ist.left), ("right", ist.right)):
            if side_key not in proxies:
                continue
            sid = s.unique_stream_id
            if sid in self.named_windows:
                if ist.left.unique_stream_id == ist.right.unique_stream_id:
                    # a window joined with itself runs each emission
                    # through ONE side (reference MultiProcessStreamReceiver
                    # with processCount 1, JoinInputStreamParser.java:129-135):
                    # the triggering one
                    keep = "right" if ist.trigger == EventTrigger.RIGHT else "left"
                    if side_key != keep:
                        continue
                self.named_windows[sid].out_junction.subscribe(proxies[side_key])
            elif partition_ctx is not None and s.is_inner_stream:
                if sid not in partition_ctx.inner_junctions:
                    raise SiddhiAppValidationException(
                        f"inner stream '{sid}' is consumed before any query "
                        f"in this partition produces it")
                partition_ctx.inner_junctions[sid].subscribe(proxies[side_key])
            else:
                self.junctions[sid].subscribe(proxies[side_key])

    def _wire_output(self, query: Query, query_name: str, runtime,
                     partition_ctx) -> None:
        """The query's output: a table action, a named window, an inner
        ``#stream`` of its partition, or a stream (auto-defined when the
        app does not define it)."""
        from siddhi_tpu_torch.core.query.output_callbacks import create_table_callback

        out = query.output_stream
        dictionary = self.app_context.string_dictionary
        if isinstance(out, (DeleteStream, UpdateStream, UpdateOrInsertStream)):
            if out.target_id not in self.tables:
                raise SiddhiAppValidationException(
                    f"'{out.target_id}' is not a defined table")
            runtime.output_action = create_table_callback(
                out, self.tables[out.target_id], query_name, runtime.output_attrs,
                dictionary)
            return
        if not isinstance(out, InsertIntoStream):
            raise SiddhiAppValidationException(
                f"unsupported output action {type(out).__name__}")
        target = out.target_id
        if target in self.tables and not out.is_inner_stream:
            runtime.output_action = create_table_callback(
                out, self.tables[target], query_name, runtime.output_attrs, dictionary)
            return
        if target in self.named_windows and not out.is_inner_stream:
            w = self.named_windows[target]
            if len(runtime.output_attrs) != len(w.definition.attributes):
                raise SiddhiAppValidationException(
                    f"insert into window '{target}': query outputs "
                    f"{len(runtime.output_attrs)} attributes, window has "
                    f"{len(w.definition.attributes)}")
            runtime.output_junction = w
            return
        if out.is_inner_stream:
            if partition_ctx is None:
                raise CompileError(
                    f"query '{query_name}': inner stream '#{target}' outside "
                    f"a partition")
            # '#stream' scoped to this partition; its rows carry pk ids
            inner_id = "#" + target
            if inner_id not in partition_ctx.inner_definitions:
                sdef = StreamDefinition(
                    id=inner_id,
                    attributes=[Attribute(n, t) for n, t in runtime.output_attrs])
                partition_ctx.inner_definitions[inner_id] = sdef
                partition_ctx.inner_junctions[inner_id] = StreamJunction(
                    sdef, self.app_context)
            runtime.output_junction = partition_ctx.inner_junctions[inner_id]
            runtime.attach_pk = True
            return
        if target not in self.stream_definitions:
            # auto-define the output stream (reference OutputParser)
            sdef = StreamDefinition(
                id=target,
                attributes=[Attribute(n, t) for n, t in runtime.output_attrs])
            self.stream_definitions[target] = sdef
            self._create_junction(sdef)
        else:
            existing = self.stream_definitions[target]
            dattrs = [(a.name, a.type) for a in existing.attributes]
            if list(runtime.output_attrs) != dattrs:
                raise SiddhiAppValidationException(
                    f"query '{query_name}' inserts {list(runtime.output_attrs)} "
                    f"into stream '{target}' defined as {dattrs}")
        runtime.output_junction = self.junctions[target]
        if partition_ctx is not None and target in partition_ctx.local_streams:
            # a partition-mate consumes this stream: its rows carry the
            # producing instance's pk
            runtime.attach_pk = True
        # record set-element types and multi-element sets on the target
        # stream, for later queries (unionSet/sizeOfSet) and event decode
        sp = runtime.selector_plan
        ometa = {n: t for n, t in sp.object_meta.items() if t is not None}
        if ometa or sp.object_multi:
            tdef = self.stream_definitions[target]
            tdef.object_elem_types = {
                **(getattr(tdef, "object_elem_types", None) or {}), **ometa}
            tdef.object_multi_attrs = (
                set(getattr(tdef, "object_multi_attrs", None) or set())
                | set(sp.object_multi))

    def _attach_rate_limiter(self, query: Query, runtime: QueryRuntime,
                             partition_ctx) -> None:
        """The query's output rate limiter (reference OutputParser): the
        group variants key on the projected group-by attributes, or on the
        group id when they are not projected; inside a partition each key
        is its own query instance, so the limiter is kept per key."""
        sp = runtime.selector_plan
        agg_positions = tuple(sp.agg_positions)
        # every join counts as windowed (QueryParser.java:149), and so does
        # a named window's consumer
        windowed = (isinstance(query.input_stream, JoinInputStream)
                    or getattr(query.input_stream, "unique_stream_id", None)
                    in self.named_windows
                    or runtime.window_stage is not None
                    or runtime.host_window is not None)
        group_key_fn = None
        if query.selector.group_by_list and rate_uses_group_key(
                query.output_rate, windowed, agg_positions):
            gb_names = {v.attribute_name for v in query.selector.group_by_list}
            positions = tuple(i for i, (n, _t) in enumerate(runtime.output_attrs)
                              if n in gb_names)
            if positions:
                group_key_fn = lambda ev, _p=positions: tuple(  # noqa: E731
                    ev.data[i] for i in _p)
            else:
                # the group key is not projected: it rides the dense group
                # id into Event.gk (within a partition GK folds the pk in)
                runtime.limiter_needs_gk = True
                group_key_fn = lambda ev: ev.gk  # noqa: E731
        partitioned = partition_ctx is not None and query.output_rate is not None
        if partitioned:
            runtime.limiter_needs_pk = True
        runtime.rate_limiter = create_rate_limiter(
            query.output_rate, runtime.send_to_callbacks, group_key_fn,
            partitioned=partitioned, windowed=windowed,
            agg_positions=agg_positions, out_size=len(runtime.output_attrs),
            empty_send=runtime.send_empty_to_query_callbacks)
        runtime.scheduler = self.app_context.scheduler

    def _prescan_object_metadata(self, siddhi_app):
        """A first pass over the query ASTs: record which object attributes
        of explicitly defined streams are multi-element sets (unionSet
        outputs) and their element types (createSet arguments), so query
        text order does not change set semantics."""

        def input_attr_type(query, var):
            sid = getattr(getattr(query, "input_stream", None), "stream_id", None)
            sdef = self.stream_definitions.get(sid) if sid else None
            if sdef is None:
                return None
            try:
                return sdef.attribute(var.attribute_name).type
            except KeyError:
                return None

        def elem_of(query, expr):
            # element type of createSet(<attribute>)
            if not (isinstance(expr, AttributeFunction)
                    and expr.name.lower() == "createset" and expr.parameters):
                return None
            arg = expr.parameters[0]
            return input_attr_type(query, arg) if isinstance(arg, Variable) else None

        def scan(query):
            out = getattr(query, "output_stream", None)
            if not isinstance(out, InsertIntoStream) or query.selector is None:
                return
            tdef = self.stream_definitions.get(out.target_id)
            if tdef is None:
                return
            for oa in query.selector.selection_list or []:
                expr = oa.expression
                if not isinstance(expr, AttributeFunction):
                    continue
                name = expr.name.lower()
                if name == "unionset" and expr.parameters:
                    tdef.object_multi_attrs = (
                        set(getattr(tdef, "object_multi_attrs", None) or set())
                        | {oa.name})
                    elem = elem_of(query, expr.parameters[0])
                elif name == "createset":
                    elem = elem_of(query, expr)
                else:
                    continue
                if elem is not None:
                    tdef.object_elem_types = {
                        **(getattr(tdef, "object_elem_types", None) or {}),
                        oa.name: elem}

        for element in siddhi_app.execution_elements:
            if isinstance(element, Query):
                scan(element)
            elif isinstance(element, Partition):
                for q in element.queries:
                    scan(q)

    # ------------------------------------------------------------- API

    def get_input_handler(self, stream_id: str) -> InputHandler:
        return self.input_manager.get_input_handler(stream_id)

    getInputHandler = get_input_handler

    def add_callback(self, id_: str, callback):
        """addCallback(streamId, StreamCallback) or (queryName,
        QueryCallback), the reference SiddhiAppRuntimeImpl overloads."""
        if isinstance(callback, StreamCallback):
            if id_ not in self.junctions:
                raise SiddhiAppValidationException(f"stream '{id_}' is not defined")
            callback.stream_id = id_
            self.junctions[id_].subscribe(callback)
        elif isinstance(callback, QueryCallback):
            if id_ not in self.query_runtimes:
                raise SiddhiAppValidationException(f"query '{id_}' not found")
            callback.query_name = id_
            self.query_runtimes[id_].query_callbacks.append(callback)
        else:
            raise TypeError(f"unsupported callback type {type(callback)}")

    addCallback = add_callback

    def remove_callback(self, callback):
        """Detach a Stream/QueryCallback: events sent after the removal no
        longer reach it (reference SiddhiAppRuntimeImpl.removeCallback)."""
        if isinstance(callback, StreamCallback):
            j = self.junctions.get(getattr(callback, "stream_id", ""))
            if j is not None and callback in j.receivers:
                j.receivers.remove(callback)
        elif isinstance(callback, QueryCallback):
            for qr in self.query_runtimes.values():
                if callback in qr.query_callbacks:
                    qr.query_callbacks.remove(callback)

    removeCallback = remove_callback

    def query(self, on_demand_query: str) -> List:
        """Run an on-demand (store) query against a table or a named
        window: a find returns its rows as Events, a mutation returns []
        (reference ``SiddhiAppRuntimeImpl.query`` +
        ``OnDemandQueryParser.java``). It holds the app barrier, so it
        never interleaves with a send."""
        from siddhi_tpu_torch.core.query.on_demand import run_on_demand_query

        # compiles resolve against this app's registry
        set_active_extensions(self._extensions)
        return run_on_demand_query(on_demand_query, self)

    @property
    def query_names(self) -> List[str]:
        return list(self.query_runtimes)

    def get_queries(self) -> List:
        """Query runtimes in declaration order (reference
        ``SiddhiAppRuntime.getQueries``)."""
        return list(self.query_runtimes.values())

    # ---------------------------------------------------- persistence API

    @property
    def persistence(self):
        from siddhi_tpu_torch.core.util.snapshot import PersistenceManager

        if getattr(self, "_persistence", None) is None:
            self._persistence = PersistenceManager(self)
        return self._persistence

    def persist(self) -> str:
        """Checkpoint all state to the configured persistence store and
        return the revision id (reference SiddhiAppRuntimeImpl.persist:677).
        Sources pause around the snapshot, so no event races it."""
        return self._sources_paused(self.persistence.persist)

    def persist_incremental(self) -> str:
        """An op-log checkpoint chained to the last revision; a full one
        when there is none."""
        return self._sources_paused(self.persistence.persist_incremental)

    def _sources_paused(self, fn):
        for sr in self.source_runtimes:
            sr.pause()
        try:
            return fn()
        finally:
            for sr in self.source_runtimes:
                sr.resume()

    def restore_revision(self, revision: str):
        self.persistence.restore_revision(revision)

    restoreRevision = restore_revision

    def restore_last_revision(self):
        return self.persistence.restore_last_revision()

    restoreLastRevision = restore_last_revision

    def clear_all_revisions(self):
        self.persistence.clear_all_revisions()

    def snapshot(self) -> bytes:
        """The app's state as snapshot bytes (reference
        SiddhiAppRuntime.snapshot)."""
        from siddhi_tpu_torch.core.util.snapshot import SnapshotService

        with self._barrier:
            return SnapshotService(self).full_snapshot()

    def restore(self, snapshot: bytes):
        from siddhi_tpu_torch.core.util.snapshot import SnapshotService

        with self._barrier:
            SnapshotService(self).restore(snapshot)

    # ------------------------------------------------------ statistics API

    def _register_statistic_probes(self):
        """DETAIL memory and buffered-events probes for every stateful
        element (reference ``monitorQueryMemoryUsage:757-782`` and
        ``monitorBufferedEvents:784-821``): a query's state tensors, a
        table's or named window's, an aggregation's host stores, an
        @Async junction's queue. Idempotent: probes are keyed by name."""
        from siddhi_tpu_torch.core.util.statistics import pytree_nbytes

        sm = self.app_context.statistics_manager
        if sm is None:
            return
        # probe sets change only when runtimes are built: a statistics()
        # polling loop must not rebuild closures per poll
        sig = (len(self.query_runtimes), len(self.tables),
               len(self.named_windows), len(self.aggregations),
               len(self.junctions))
        if getattr(self, "_probe_sig", None) == sig:
            return
        self._probe_sig = sig
        for name, qr in self.query_runtimes.items():
            sm.register_memory_probe(
                f"query.{name}", lambda q=qr: pytree_nbytes(q._state))
        for name, t in self.tables.items():
            sm.register_memory_probe(
                f"table.{name}", lambda tb=t: _element_state_bytes(tb))
        for name, w in self.named_windows.items():
            sm.register_memory_probe(
                f"window.{name}", lambda win=w: _element_state_bytes(win))
        for name, agg in self.aggregations.items():
            sm.register_memory_probe(
                f"aggregation.{name}", lambda a=agg: _agg_store_bytes(a))
        for sid, j in self.junctions.items():
            if getattr(j, "_queue", None) is not None:
                sm.register_buffer_probe(
                    f"junction.{sid}", lambda jn=j: jn._queue.qsize())

    def statistics(self) -> dict:
        """Metrics snapshot (reference SiddhiAppRuntime.getStatistics)."""
        sm = self.app_context.statistics_manager
        if sm is None:
            return {"level": "off"}
        self._register_statistic_probes()   # cover late-built runtimes
        return sm.report()

    def set_statistics_level(self, level: str):
        """'off' | 'basic' | 'detail' (reference setStatisticsLevel)."""
        from siddhi_tpu_torch.core.util.statistics import StatisticsManager, parse_level

        if self.app_context.statistics_manager is None:
            self.app_context.statistics_manager = StatisticsManager()
        self.app_context.statistics_manager.set_level(parse_level(level))
        self._register_statistic_probes()

    setStatisticsLevel = set_statistics_level

    def start_trace(self, log_dir: str):
        """Start the device profiler trace into ``log_dir``
        (``observability/device_trace.py``: ``torch.profiler`` with host
        and, on the card, CUDA activity; each hand-written kernel under its
        own name, a CUDA-graph replay's included). ``stop_trace`` writes a
        Chrome trace file there. A second start raises."""
        from siddhi_tpu_torch.observability import device_trace

        if self._tracing:
            raise RuntimeError("a trace is already running")
        device_trace.start(log_dir)
        self._tracing = True
        return log_dir

    def stop_trace(self):
        """Stop this app's device trace (from the thread that started it);
        returns the trace file's path. A stop with no trace running
        raises."""
        from siddhi_tpu_torch.observability import device_trace

        if not self._tracing:
            raise RuntimeError("no trace is running")
        path = device_trace.stop()
        self._tracing = False
        return path

    def debug(self):
        """Attach a SiddhiDebugger (reference SiddhiAppRuntime.debug). Its
        breakpoints wrap each query runtime's delivery methods, which a
        fused group bypasses: the app's fused groups dissolve first."""
        from siddhi_tpu_torch.core.debugger import SiddhiDebugger

        if self._debugger is None:
            for g in list(self.fused_fanout_groups):
                g.dissolve()
            self.fused_fanout_groups = []
            self._debugger = SiddhiDebugger(self)
        return self._debugger

    # ------------------------------------------------------ resilience API

    def enable_autopilot(self, mode: str = "on", interval_s: Optional[float] = None,
                         cooldown_s: Optional[float] = None):
        """Arm the closed-loop controller (``autopilot/``): the API spelling
        of the ``siddhi_tpu.autopilot`` knob. ``mode`` is ``'on'`` or
        ``'dry_run'`` (decide and log, never actuate). Idempotent; the app
        registers with the process-wide controller here when it has
        started, else at ``start()``. Returns the controller."""
        from siddhi_tpu_torch.autopilot.controller import AutopilotController
        from siddhi_tpu_torch.core.util.knobs import KNOBS

        self.app_context.autopilot = KNOBS["autopilot"].parse(mode)
        if self.app_context.autopilot == "off":
            raise ValueError("enable_autopilot with mode 'off': use the config "
                             "knob to keep the controller out")
        if interval_s is not None:
            self.app_context.autopilot_interval_s = float(interval_s)
        if cooldown_s is not None:
            self.app_context.autopilot_cooldown_s = float(cooldown_s)
        ctl = AutopilotController.instance()
        if self._started:
            ctl.register(self)
        return ctl

    def enable_wal(self, max_batches: int = 4096, max_events=None):
        """Attach a bounded ingest WAL (``resilience/replay.py``): every
        accepted batch is recorded until the next checkpoint trims it, and
        ``restore_revision`` replays the retained suffix, so a checkpoint
        restore is effectively-once. Idempotent; returns the WAL."""
        from siddhi_tpu_torch.resilience.replay import IngestWAL, register_wal_gauges

        if self.app_context.ingest_wal is None:
            self.app_context.ingest_wal = IngestWAL(
                max_batches=max_batches, max_events=max_events,
                app_context=self.app_context)
        register_wal_gauges(self.app_context)
        return self.app_context.ingest_wal

    def supervise(self, interval_s: float = 0.25, wedge_timeout_s: float = 5.0,
                  peer_recovery=None, peer_monitor=None):
        """Start an ``AppSupervisor`` (``resilience/supervisor.py``) that
        heartbeats this app's @Async workers, replacing dead or wedged
        ones with their queues intact, heals dead ingest packers and
        watches the pipeline for a wedged step, and, when
        ``peer_recovery`` is given, runs the cluster-peer recovery protocol
        on a peer failure (a ``ClusterPeerError`` from the bounded pull or
        a collective, or a lost ``peer_monitor`` heartbeat). Idempotent;
        returns the supervisor."""
        from siddhi_tpu_torch.resilience.supervisor import AppSupervisor

        if self.app_context.supervisor is None:
            AppSupervisor(self, interval_s=interval_s,
                          wedge_timeout_s=wedge_timeout_s,
                          peer_recovery=peer_recovery,
                          peer_monitor=peer_monitor).start()
        return self.app_context.supervisor

    def start(self):
        """Start @Async workers, the ingest pool, sinks and sources, table
        cache sweeps and triggers (also done by the first send)."""
        with self._barrier:   # a lazy start can race concurrent first sends
            if self._started:
                return
            self._started = True
            ctx = self.app_context
            # the profiling knobs: one refcounted process-wide enable each,
            # paired with the disables in shutdown()
            if ctx.profile_costs and not self._costs_on:
                from siddhi_tpu_torch.observability import costmodel

                costmodel.enable()
                self._costs_on = True
            if ctx.profile_journeys and not self._journeys_on:
                from siddhi_tpu_torch.observability import journey

                journey.enable()
                self._journeys_on = True
            if ctx.profile_device_instruments and not self._instruments_on:
                from siddhi_tpu_torch.observability import instruments

                instruments.enable()
                self._instruments_on = True
            if ctx.ingest_pool > 0 and ctx.ingest_pack_pool is None:
                from siddhi_tpu_torch.core.stream.input.pack_pool import IngestPackPool

                ctx.ingest_pack_pool = IngestPackPool(
                    ctx, workers=ctx.ingest_pool, split_rows=ctx.ingest_split)
            # the closed-loop controller (autopilot/): registered when the
            # knob is armed; 'off' (the default) keeps the engine free of
            # any controller thread, observation or actuation
            if ctx.autopilot != "off":
                from siddhi_tpu_torch.autopilot.controller import AutopilotController

                AutopilotController.instance().register(self)
            for j in self.junctions.values():
                j.start_processing()
            for qr in self.query_runtimes.values():
                if qr.rate_limiter is not None:
                    qr.rate_limiter.start(ctx.scheduler)
                if hasattr(qr, "arm_initial"):
                    qr.arm_initial()  # head-absent patterns wait from start
            for agg in self.aggregations.values():
                if agg.purge_enabled:
                    ctx.scheduler.schedule_periodic(
                        agg.purge_interval_ms, lambda ts, a=agg: a.purge(ts))
            if ctx.statistics_manager is not None:
                ctx.statistics_manager.start_reporting(ctx.scheduler)
                self._register_statistic_probes()
            for pctx in self.partition_contexts:
                if pctx.purge_interval_ms is not None:
                    ctx.scheduler.schedule_periodic(
                        pctx.purge_interval_ms,
                        lambda _ts, p=pctx: p.purge())  # wall clock, not event time
            for t in self.tables.values():
                # cache retention sweeps (reference CacheExpirer)
                cache = getattr(t, "cache", None)
                if cache is not None and cache.retention_ms is not None:
                    ctx.scheduler.schedule_periodic(
                        cache.purge_interval_ms, lambda _ts, c=cache: c.expire())
            for sr in self.sink_runtimes:
                sr.connect()
            for sr in self.source_runtimes:
                # connect with retry/backoff off-thread (Source.java:155-185)
                threading.Thread(target=sr.connect_with_retry, daemon=True).start()
            for tr in self.trigger_runtimes:
                tr.start()

    def shutdown(self):
        import logging

        ctx = self.app_context
        ctx.stopped = True
        if ctx.autopilot != "off":
            # detach FIRST: no actuation may land on a tearing-down app
            # (pinned to this runtime: an old runtime shutting down never
            # strips a newer same-named app's registration)
            from siddhi_tpu_torch.autopilot.controller import AutopilotController

            AutopilotController.instance().unregister(ctx.name, app_runtime=self)
        if ctx.supervisor is not None:
            ctx.supervisor.stop()
        if ctx.overload is not None:
            # the process-wide registration goes (its fair-scheduler slot,
            # its control), pinned to this app's control: shutting down an
            # OLD runtime never strips a newer same-named app's quotas
            from siddhi_tpu_torch.resilience.overload import OverloadManager

            OverloadManager.instance().unregister(ctx.name, ctl=ctx.overload)
            ctx.overload = None
        ctx.timestamp_generator.stop_heartbeat()
        if ctx.completion_pump.has_pending:
            # batches still riding the pipeline emit before teardown
            try:
                ctx.completion_pump.flush()
            except RuntimeError:
                logging.getLogger(__name__).exception(
                    "pipeline flush failed during shutdown")
        if ctx.statistics_manager is not None:
            ctx.statistics_manager.stop_reporting(ctx.scheduler)
        for sr in self.source_runtimes:
            sr.shutdown()
        for tr in self.trigger_runtimes:
            tr.stop()
        for qr in self.query_runtimes.values():
            if qr.rate_limiter is not None:
                qr.rate_limiter.stop()
        for j in self.junctions.values():
            # an @Async worker delivers its queue, flushes, then exits
            j.stop_processing()
        for sr in self.sink_runtimes:
            sr.shutdown()
        if ctx.ingest_pack_pool is not None:
            # after the workers stopped: no pack can be in flight
            ctx.ingest_pack_pool.shutdown()
            ctx.ingest_pack_pool = None
        if ctx.scheduler is not None:
            ctx.scheduler.shutdown()
        with self._barrier:
            for g in self.fused_fanout_groups:
                g.close()     # the captured graphs' pools
            # drop device state so the app's memory is released now; under
            # each query's lock, so a timer that fired before the scheduler
            # stopped finds `stopped` set and the state gone, never half
            for q in self.query_runtimes.values():
                with q._lock:
                    q._state = None
                    q.drop_step()
                    q._staging = None
            # the program cache: this app's refs go, and an entry no other
            # app holds frees its graphs and slot now
            from siddhi_tpu_torch.core.util import program_cache

            program_cache.cache().release_owner(ctx.telemetry)
        if self._costs_on:
            from siddhi_tpu_torch.observability import costmodel

            costmodel.disable()
            self._costs_on = False
        from siddhi_tpu_torch.observability import instruments, journey

        # this app's wall tracking dies with it (a redeployed app of the
        # same name starts a fresh observation window)
        journey.forget_app(ctx.name)
        if self._journeys_on:
            journey.disable()
            self._journeys_on = False
        if self._instruments_on:
            instruments.disable()
            self._instruments_on = False


def _element_state_bytes(el) -> int:
    """State footprint of a table or named window: its state tensors, or a
    host-mode window's stage snapshot."""
    from siddhi_tpu_torch.core.util.statistics import pytree_nbytes

    st = getattr(el, "state", None)
    if st is not None:
        return pytree_nbytes(st)
    stage = getattr(el, "stage", None)
    if stage is not None and hasattr(stage, "snapshot"):
        return pytree_nbytes(stage.snapshot())
    return 0


def _agg_store_bytes(agg) -> int:
    """State footprint of an incremental aggregation: its stored base
    values, 8 bytes each (the sharded runtime's in its shards)."""
    total = 0
    for holder in (getattr(agg, "shards", None) or [agg]):
        for dstore in getattr(holder, "store", {}).values():
            for groups in dstore.values():
                for vals in groups.values():
                    total += 8 * len(vals)
    return total
