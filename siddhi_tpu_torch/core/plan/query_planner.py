"""Query planner: query-api Query -> QueryRuntime.

Counterpart of ``plan_query`` in ``siddhi_tpu/core/plan/query_planner.py``
for the shapes the port runs: a single input stream with stream functions
(``#log``, ``#pol2Cart``, extensions), filters and at most one window
(keyed inside a partition, per query outside; the map and comparator
windows on the host), filters and stream functions after the window, a
selector with every aggregator, ``group by``, ``having``, ``order by``
and ``limit``/``offset`` (collapsing batch-window chunks), function calls
anywhere an expression stands, string<->number casts of stream attributes
(host parse and format stages) and every ``output`` rate. An unpartitioned
length window whose aggregators are all invertible takes the fused stage
(``ops/fused_agg.py``), as the reference decides it. Patterns and
sequences plan through ``plan_nfa_query`` into an ``NFAQueryRuntime``.
Two-stream joins (stream, table and named-window sides, inside and
outside partitions) plan through ``plan_join_query`` into a
``JoinQueryRuntime``; an ``<cond> in <table>`` filter becomes a host
exists-probe (``ops/stream_functions.InProbeStage``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException
from siddhi_tpu_torch.core.plan.resolvers import SingleStreamResolver
from siddhi_tpu_torch.core.plan.selector_plan import plan_selector
from siddhi_tpu_torch.core.query.runtime import GroupKeyer, QueryRuntime
from siddhi_tpu_torch.ops.expressions import CompileError, compile_condition, compile_expr
from siddhi_tpu_torch.ops.fused_agg import plan_fused_window
from siddhi_tpu_torch.ops.keyed_windows import create_keyed_window_stage
from siddhi_tpu_torch.ops.windows import LengthWindowStage, create_window_stage
from siddhi_tpu_torch.query_api.definitions import AttrType, StreamDefinition
from siddhi_tpu_torch.query_api.execution import (
    EventTrigger,
    Filter,
    JoinInputStream,
    JoinType,
    OutputAttribute,
    Query,
    SingleInputStream,
    SnapshotOutputRate,
    StateInputStream,
    StreamFunction,
    Window,
)
from siddhi_tpu_torch.query_api.expressions import (
    And,
    AttributeFunction,
    Compare,
    Constant,
    Expression,
    InOp,
    Variable,
)


def _plan_stream_function_handler(handler, resolver, query_name, filters,
                                  transforms, ext_def, base_def):
    """Plan one ``#name(args)`` handler: returns ``(log_stage_or_None,
    ext_def)``. A transform stage is appended to ``transforms``, its output
    attributes registered as resolver synthetics and folded into the
    (copy-on-write) extended definition."""
    from siddhi_tpu_torch.ops.stream_functions import LogStage, plan_stream_function

    stage = plan_stream_function(
        handler, resolver, query_name, len(filters), len(transforms))
    if isinstance(stage, LogStage):
        return stage, ext_def
    taken = {a.name for a in ext_def.attributes}
    for a in stage.out_attrs:
        if a.name in taken:
            raise CompileError(
                f"stream function '{handler.name}' output attribute "
                f"'{a.name}' collides with an existing attribute")
        resolver.synthetic[a.name] = a.type
    if ext_def is base_def:
        ext_def = StreamDefinition(base_def.id, list(base_def.attributes))
    ext_def.attributes = ext_def.attributes + stage.out_attrs
    transforms.append(stage)
    return None, ext_def


def _rewrite_string_casts(expr, input_def, resolver, transforms, ext_state,
                          dictionary):
    """Replace ``cast/convert(<string attr>, '<numeric>')`` and
    ``cast/convert(<numeric attr>, 'string')`` nodes with synthetic
    Variables backed by a host parse or format transform (strings are
    dictionary ids: parsing happens on the host once per new dictionary
    entry, the device sees a numeric column)."""
    from siddhi_tpu_torch.ops.expressions import _TYPE_NAMES

    if not isinstance(expr, Expression):
        return expr
    for attr in ("left", "right", "expression"):
        child = getattr(expr, attr, None)
        if isinstance(child, Expression):
            setattr(expr, attr, _rewrite_string_casts(
                child, input_def, resolver, transforms, ext_state, dictionary))
    if not isinstance(expr, AttributeFunction):
        return expr
    expr.parameters = [
        _rewrite_string_casts(p, input_def, resolver, transforms, ext_state,
                              dictionary)
        for p in expr.parameters]
    # every castable target except string (that cast goes the other way)
    numeric = {k: v for k, v in _TYPE_NAMES.items() if v != AttrType.STRING}
    if not (not expr.namespace and expr.name.lower() in ("cast", "convert")
            and len(expr.parameters) == 2
            and isinstance(expr.parameters[1], Constant)
            and isinstance(expr.parameters[1].value, str)
            and isinstance(expr.parameters[0], Variable)):
        return expr
    tname = expr.parameters[1].value.lower()
    var = expr.parameters[0]
    try:
        src = input_def.attribute(var.attribute_name)
    except Exception:
        return expr
    if not resolver.accepts_stream(var.stream_id):
        return expr
    from siddhi_tpu_torch.ops.stream_functions import (
        NumericFormatCastStage, StringParseCastStage)

    stage = None
    if src.type == AttrType.STRING and tname in numeric:
        target = numeric[tname]
        key = (src.name, target)
        name = ext_state["casts"].get(key)
        if name is None:
            name = f"__cast{len(ext_state['casts'])}__"
            stage = StringParseCastStage(name, src.name, target, dictionary)
            resolver.synthetic[name] = target
    elif (src.type != AttrType.STRING and tname == "string"
          and src.type != AttrType.OBJECT):
        key = (src.name, AttrType.STRING)
        name = ext_state["casts"].get(key)
        if name is None:
            name = f"__cast{len(ext_state['casts'])}__"
            stage = NumericFormatCastStage(name, src.name, src.type, dictionary)
            resolver.synthetic[name] = AttrType.STRING
    else:
        return expr
    if stage is not None:
        ext_state["casts"][key] = name
        transforms.append(stage)
        ext_state["attrs"].extend(stage.out_attrs)
        ext_state["internal"].add(name)
    return Variable(attribute_name=name)


def _rewrite_in_conditions(expr, input_def, ref_id, resolver, app_context,
                           transforms, ext_state):
    """Replace ``<cond> in Table`` nodes with synthetic bool Variables
    backed by a host exists-probe over the table's rows
    (InConditionExpressionExecutor). The inner condition compiles with the
    table's own resolver (TableConditionResolver + InMemoryTable._match),
    sharing the binding rules of joins, updates and deletes."""
    from siddhi_tpu_torch.core.table.in_memory_table import TableConditionResolver
    from siddhi_tpu_torch.ops.stream_functions import InProbeStage

    if not isinstance(expr, Expression):
        return expr
    for attr in ("left", "right", "expression"):
        child = getattr(expr, attr, None)
        if isinstance(child, Expression) and not isinstance(expr, InOp):
            setattr(expr, attr, _rewrite_in_conditions(
                child, input_def, ref_id, resolver, app_context, transforms,
                ext_state))
    if isinstance(expr, AttributeFunction):
        expr.parameters = [
            _rewrite_in_conditions(p, input_def, ref_id, resolver, app_context,
                                   transforms, ext_state)
            for p in expr.parameters]
    if not isinstance(expr, InOp):
        return expr
    table = app_context.tables.get(expr.source_id)
    if table is None:
        raise CompileError(
            f"'{expr.source_id}' in an `in` condition is not a defined table")
    pair = TableConditionResolver(table.definition, input_def,
                                  app_context.string_dictionary, event_ref=ref_id)
    stage = InProbeStage(f"__in{len(transforms)}__", table,
                         compile_condition(expr.expression, pair))
    name = stage.out_attrs[0].name
    resolver.synthetic[name] = AttrType.BOOL
    transforms.append(stage)
    ext_state["attrs"].extend(stage.out_attrs)
    ext_state["internal"].add(name)
    return Variable(attribute_name=name)


def _selector_has_aggregator(selector) -> bool:
    """Does a selection or the having clause call an aggregator?"""
    from siddhi_tpu_torch.ops.aggregators import supported_aggregators

    names = supported_aggregators()

    def scan(expr) -> bool:
        if not isinstance(expr, Expression):
            return False
        if (isinstance(expr, AttributeFunction) and not expr.namespace
                and expr.name.lower() in names):
            return True
        for attr in ("left", "right", "expression"):
            child = getattr(expr, attr, None)
            if isinstance(child, Expression) and scan(child):
                return True
        return isinstance(expr, AttributeFunction) and any(
            scan(p) for p in expr.parameters)

    exprs = [oa.expression for oa in (selector.selection_list or [])]
    if selector.having is not None:
        exprs.append(selector.having)
    return any(scan(e) for e in exprs)


def _probe_type_safe(attr_t, val_t) -> bool:
    """An index probe casts the value into the column's dtype: allowed
    only where that cast cannot change equality against the promoted
    broadcast compare (the same type, or a widening numeric cast)."""
    from siddhi_tpu_torch.ops import types as T

    if attr_t == val_t:
        return True
    if T.is_numeric(attr_t) and T.is_numeric(val_t):
        try:
            return T.promote(attr_t, val_t) == attr_t
        except Exception:
            return False
    return False


def _vars_of(e, out):
    if isinstance(e, Variable):
        out.append(e)
    for name in ("left", "right", "expression"):
        c = getattr(e, name, None)
        if c is not None and not isinstance(c, (str, int, float, bool)):
            _vars_of(c, out)
    if isinstance(e, AttributeFunction):
        for p in e.parameters:
            _vars_of(p, out)
    return out


def _extract_join_index_probe(on_expr, left, right, resolver):
    """``T.attr == <expr over the other side>`` (the whole condition, or
    one conjunct of a top-level And) where T is an in-memory table side
    or an aggregation side (its group attributes) and ``attr`` one of its
    ``probe_attrs()``: the spec of
    ``JoinQueryRuntime.index_probe``, or None."""
    from siddhi_tpu_torch.core.query.join_runtime import AggregationJoinStore
    from siddhi_tpu_torch.core.table.in_memory_table import InMemoryTable

    def side_ids(s):
        return {s.stream_id, s.ref_id} - {None}

    def try_eq(e):
        if not isinstance(e, Compare) or e.operator != "==":
            return None
        for store_side in (left, right):
            store = store_side.store
            if not isinstance(store, (InMemoryTable, AggregationJoinStore)):
                continue
            other_side = right if store_side is left else left
            probe_attrs = store.probe_attrs()
            for tvar, vexpr in ((e.left, e.right), (e.right, e.left)):
                if not (isinstance(tvar, Variable)
                        and tvar.stream_id in side_ids(store_side)
                        and tvar.attribute_name in probe_attrs):
                    continue
                # the value expression reads the other side only
                vs = _vars_of(vexpr, [])
                if not vs or any(v.stream_id is None
                                 or v.stream_id in side_ids(store_side)
                                 or v.stream_id not in side_ids(other_side)
                                 for v in vs):
                    continue
                val_fn, val_t = compile_expr(vexpr, resolver)
                attr_t = store.definition.attribute(tvar.attribute_name).type
                if not _probe_type_safe(attr_t, val_t):
                    # a narrowing cast (double -> long) would change the
                    # equality the indexed path no longer re-evaluates
                    continue
                return {"store_side": store_side.key, "attr": tvar.attribute_name,
                        "val_fn": val_fn, "residual_fn": None}
        return None

    hit = try_eq(on_expr)
    if hit is not None:
        return hit
    if isinstance(on_expr, And):
        for this, rest in ((on_expr.left, on_expr.right),
                           (on_expr.right, on_expr.left)):
            hit = try_eq(this)
            if hit is not None:
                hit["residual_fn"] = compile_condition(rest, resolver)
                return hit
    return None


def plan_join_query(query: Query, query_name: str, app_context,
                    definitions: Dict[str, StreamDefinition],
                    partition_ctx=None):
    """Plan a two-stream window join (reference
    ``JoinInputStreamParser.java:200-348`` + ``JoinProcessor.java``)."""
    from siddhi_tpu_torch.core.join import attach_join_engine
    from siddhi_tpu_torch.core.query.join_runtime import (
        AggregationJoinStore, JoinQueryRuntime, JoinResolver, JoinSide)
    from siddhi_tpu_torch.ops.windows import PassthroughWindowStage, window_col_specs

    join: JoinInputStream = query.input_stream
    dictionary = app_context.string_dictionary
    # outputExpectsExpiredEvents (JoinInputStreamParser): `insert into`
    # joins never drain batch windows' findable queues, so probes keep
    # seeing the last non-empty batch across empty timer flushes
    oet = query.output_stream.output_event_type if query.output_stream else "current"
    side_expired_needed = oet != "current"
    # EmptyWindowProcessor's per-event [CURRENT, EXPIRED?, RESET] matters
    # only where the selector aggregates or groups: the RESET rows restart
    # per-trigger aggregates (and a RESET from a non-triggering side would
    # wrongly wipe them)
    needs_reset = (bool(query.selector.group_by_list)
                   or _selector_has_aggregator(query.selector))

    def side_triggers(key: str) -> bool:
        return (join.trigger == EventTrigger.ALL
                or (join.trigger == EventTrigger.LEFT and key == "left")
                or (join.trigger == EventTrigger.RIGHT and key == "right"))

    def build_side(key: str, s: SingleInputStream) -> JoinSide:
        sid = s.unique_stream_id
        if sid in app_context.aggregations:
            # an aggregation side: the stitched buckets are the probe store
            # (AggregationRuntime.java:331-357 + join `within ... per ...`)
            if s.handlers:
                raise CompileError(
                    f"query '{query_name}': handlers on the aggregation join "
                    f"side '{sid}' are not supported")
            duration, within, dyn = _agg_join_range(join, query_name)
            store = AggregationJoinStore(app_context.aggregations[sid], duration, within)
            store.dynamic_raw = dyn
            return JoinSide(
                key=key, stream_id=sid, ref_id=s.stream_reference_id,
                definition=store.definition, window_stage=None, filters=[],
                triggers=False, outer=False, store=store)
        if sid in app_context.tables or sid in app_context.named_windows:
            # a shared store side (reference TableWindowProcessor /
            # WindowWindowProcessor as the findable side); a named window
            # also triggers with its emission stream, a table cannot
            is_window = sid in app_context.named_windows
            store = (app_context.named_windows if is_window
                     else app_context.tables)[sid]
            if s.handlers:
                raise CompileError(
                    f"query '{query_name}': handlers on the {sid} store join "
                    f"side are not supported")
            stage = (PassthroughWindowStage(window_col_specs(store.definition),
                                            pass_expired=True)
                     if is_window else None)
            return JoinSide(
                key=key, stream_id=sid, ref_id=s.stream_reference_id,
                definition=store.definition, window_stage=stage, filters=[],
                triggers=is_window and side_triggers(key), outer=False,
                store=store)
        if sid not in definitions:
            raise CompileError(f"query '{query_name}': stream '{sid}' is not defined")
        sdef = definitions[sid]
        resolver = SingleStreamResolver(sdef, dictionary, ref_id=s.stream_reference_id)
        # inside a partition every join side keeps per-key window state,
        # a global (non-partitioned) stream side too: the reference
        # instantiates the query per key, each instance with its own copy
        # of the global stream's window, fed only while it exists
        # (JoinPartitionTestCase test10)
        side_global = partition_ctx is not None and not (
            s.is_inner_stream or sid in partition_ctx.keyers
            or sid in partition_ctx.local_streams)
        filters, post_filters, transforms = [], [], []
        window_stage = host_window = None
        ext_sdef = sdef  # grows as stream functions append attributes
        for h in s.handlers:
            if isinstance(h, Filter):
                (post_filters if window_stage is not None else filters).append(
                    compile_condition(h.expression, resolver))
            elif isinstance(h, Window):
                if window_stage is not None:
                    raise CompileError("only one #window per join side is allowed")
                if partition_ctx is not None:
                    window_stage = create_keyed_window_stage(
                        h, ext_sdef, resolver, app_context,
                        expired_needed=side_expired_needed)
                    if not getattr(window_stage, "keyed", False):
                        raise CompileError(
                            f"window '{h.name}' cannot be a join side inside "
                            f"a partition (no per-key probe surface)")
                else:
                    window_stage = create_window_stage(
                        h, ext_sdef, resolver, app_context,
                        expired_needed=side_expired_needed)
                if getattr(window_stage, "host_mode", False):
                    # sort/frequent/...: the window runs on the host, its
                    # emissions trigger the join, its contents are probed
                    host_window = window_stage
                    window_stage = PassthroughWindowStage(
                        window_col_specs(ext_sdef), pass_expired=True)
            else:
                if window_stage is not None:
                    raise CompileError(
                        "post-window stream functions on join sides are not supported")
                log_stage, ext_sdef = _plan_stream_function_handler(
                    h, resolver, query_name, filters, transforms, ext_sdef, sdef)
                if log_stage is not None:
                    raise CompileError("#log() on a join side is not supported")
        if window_stage is None:
            if partition_ctx is not None:
                raise CompileError(
                    f"query '{query_name}': joins inside partitions need an "
                    f"explicit #window on stream side '{sid}'")
            window_stage = PassthroughWindowStage(
                window_col_specs(ext_sdef),
                empty_window=(needs_reset or side_expired_needed) and side_triggers(key),
                expired_needed=side_expired_needed, emit_reset=needs_reset)
        outer = ((join.type == JoinType.LEFT_OUTER_JOIN and key == "left")
                 or (join.type == JoinType.RIGHT_OUTER_JOIN and key == "right")
                 or join.type == JoinType.FULL_OUTER_JOIN)
        return JoinSide(
            key=key, stream_id=sdef.id, ref_id=s.stream_reference_id,
            definition=ext_sdef, window_stage=window_stage, filters=filters,
            triggers=side_triggers(key), outer=outer, host_window=host_window,
            keyer=(partition_ctx.keyers.get(sid)
                   if partition_ctx is not None else None),
            transforms=transforms,
            input_definition=sdef if ext_sdef is not sdef else None,
            post_filters=post_filters, global_side=side_global,
            carried_pk=partition_ctx is not None and (
                s.is_inner_stream or sid in partition_ctx.local_streams))

    left = build_side("left", join.left)
    right = build_side("right", join.right)
    for sd in (left, right):
        if sd.global_side and sd.outer:
            raise CompileError(
                f"query '{query_name}': outer join on the non-partitioned "
                f"side '{sd.stream_id}' inside a partition is not supported")
    if (join.within is not None or join.per is not None) and not any(
            isinstance(sd.store, AggregationJoinStore) for sd in (left, right)):
        raise CompileError(
            f"query '{query_name}': `within`/`per` join clauses need an "
            f"aggregation join side")
    if left.window_stage is None and right.window_stage is None:
        raise CompileError(
            f"query '{query_name}': a join needs an event-driven side — both "
            f"'{left.stream_id}' and '{right.stream_id}' are tables")
    if not (left.triggers or right.triggers):
        # `unidirectional` pointing at a table side: the reference compiles
        # a query that can never emit; refused here
        raise CompileError(
            f"query '{query_name}': no join side can trigger output — the "
            f"unidirectional/trigger side must be a stream or named window")
    for sd, stream_side in ((left, right), (right, left)):
        if isinstance(sd.store, AggregationJoinStore) and sd.store.dynamic_raw:
            _compile_dynamic_agg_range(sd.store, stream_side, dictionary)
    resolver = JoinResolver(left, right, dictionary)
    on_cond = (compile_condition(join.on_compare, resolver)
               if join.on_compare is not None else None)
    # `on T.attr == <expr over the other side>` against an indexed table
    # side: a searchsorted over the sorted column instead of the [N, W]
    # compare (the reference's IndexedEventHolder probe)
    index_probe = agg_probe = None
    if join.on_compare is not None:
        probe = _extract_join_index_probe(join.on_compare, left, right, resolver)
        if partition_ctx is None:
            index_probe = probe
        elif probe is not None and isinstance(
                (left if probe["store_side"] == left.key else right).store,
                AggregationJoinStore):
            # inside a partition the reference keeps the [N, W] compare;
            # an aggregation's stitched buckets (every key's, every
            # period's) make that [rows, keys x periods], so the port
            # probes them by group attribute there too
            agg_probe = probe
    if query.selector.select_all or not query.selector.selection_list:
        raise CompileError(
            f"query '{query_name}': join queries need an explicit select list")
    # QuerySelector batch-processes every chunk and JoinProcessor makes one
    # chunk per trigger event, so grouped or aggregated joins collapse to
    # the last row per (trigger event, group) (JoinTableTestCase query9);
    # the join step stamps the flush key with the trigger row
    selector_plan = plan_selector(
        selector=query.selector, input_attrs=[], resolver=resolver,
        output_event_type=oet, batch_mode=True, dictionary=dictionary,
        app_context=app_context)
    selector_plan.num_keys = app_context.initial_key_capacity
    group_keyer = None
    if query.selector.group_by_list:
        group_keyer = GroupKeyer([compile_expr(v, resolver)
                                  for v in query.selector.group_by_list])
    rt = JoinQueryRuntime(
        name=query_name, app_context=app_context, left=left, right=right,
        on_cond=on_cond, selector_plan=selector_plan, dictionary=dictionary,
        partition_ctx=partition_ctx, group_keyer=group_keyer)
    rt.index_probe = index_probe
    rt.partition_agg_probe = agg_probe
    attach_join_engine(rt, join.on_compare)
    return rt


def _agg_join_range(join: JoinInputStream, query_name: str):
    """Parse `within .. per ..` of an aggregation join into (Duration | None,
    (start, end) | None, dynamic_raw | None). Constants (unix-ms longs,
    'yyyy-MM-dd HH:mm:ss' strings, single wildcard patterns) resolve at
    plan time; expressions over the stream side (``per i.perValue``) are
    returned raw for per-event resolution (reference AggregationRuntime's
    startTimeEndTime/per executors run per matching event)."""
    from siddhi_tpu_torch.core.aggregation.incremental import parse_duration_name
    from siddhi_tpu_torch.core.aggregation.within_time import (
        WithinFormatError, resolve_within_pair, single_within_range)
    from siddhi_tpu_torch.query_api.expressions import Constant, TimeConstant

    dynamic: dict = {}
    if join.per is None:
        raise CompileError(
            f"query '{query_name}': an aggregation join needs `per '<duration>'`")
    if isinstance(join.per, Constant) and isinstance(join.per.value, str):
        duration = parse_duration_name(join.per.value)
    else:
        duration = None
        dynamic["per"] = join.per

    def _const(x):
        return x.value if isinstance(x, (Constant, TimeConstant)) else None

    w = join.within
    within = None
    try:
        if w is None:
            pass
        elif isinstance(w, tuple):
            a, b = _const(w[0]), _const(w[1])
            if a is None or b is None:
                dynamic["within"] = w
            else:
                within = resolve_within_pair(a, b)
        elif isinstance(w, Constant) and isinstance(w.value, str):
            # single wildcard pattern: the whole calendar unit it names
            within = single_within_range(w.value)
        elif isinstance(w, (Constant, TimeConstant)):
            # single-bound within must be a date-pattern STRING (reference
            # startTimeEndTime single-arg validation — test36)
            raise CompileError(
                f"query '{query_name}': a single within bound must be a "
                f"date-pattern string ('**' wildcards allowed)")
        else:
            dynamic["within"] = (w,)
    except WithinFormatError as e:
        raise CompileError(f"query '{query_name}': {e}") from None
    return duration, within, (dynamic or None)


def _compile_dynamic_agg_range(store, stream_side, dictionary):
    """Compile per-event `within`/`per` expressions of an aggregation join
    against the STREAM side's row columns; the store resolves them per
    trigger event at probe time (reference AggregationRuntime per-event
    startTimeEndTime/per executors — Aggregation1TestCase test6's
    ``within i.startTime, i.endTime per i.perValue``). The compiled
    closures return RAW per-row values (strings decoded from the
    dictionary); parsing happens per row in the store so one bad row
    can't void a whole batch."""
    from siddhi_tpu_torch.ops.expressions import VALID_KEY, compile_expr
    from siddhi_tpu_torch.query_api.definitions import AttrType

    resolver = SingleStreamResolver(
        stream_side.definition, dictionary, ref_id=stream_side.ref_id)

    def host_values(expr):
        fn, t = compile_expr(expr, resolver)
        is_str = t == AttrType.STRING

        def values(cols, ctx):
            v, _m = fn(cols, ctx)
            # constant sub-expressions compile to 0-d scalars — broadcast
            # against the batch before iterating per row
            v = np.broadcast_to(np.asarray(v), np.shape(cols[VALID_KEY]))
            if is_str:
                return [dictionary.decode(int(i)) for i in v]
            return [int(x) for x in v]

        return values, t

    raw = store.dynamic_raw
    per_of = None
    if raw.get("per") is not None:
        per_of, _t = host_values(raw["per"])
    within_of = None
    w = raw.get("within")
    if w is not None:
        if isinstance(w, tuple) and len(w) == 2:
            (b0, _t0), (b1, _t1) = host_values(w[0]), host_values(w[1])

            def within_of(cols, ctx):
                return list(zip(b0(cols, ctx), b1(cols, ctx)))
        else:
            bv, t = host_values(w[0] if isinstance(w, tuple) else w)
            if t != AttrType.STRING:
                # same single-bound rule as the static path: must be a
                # date-pattern string (startTimeEndTime single-arg)
                raise CompileError(
                    "a single within bound must be a date-pattern string "
                    "('**' wildcards allowed)")

            def within_of(cols, ctx):
                return bv(cols, ctx)
    store.dynamic = (per_of, within_of)


def plan_nfa_query(query: Query, query_name: str, app_context,
                   definitions: Dict[str, StreamDefinition],
                   partition_ctx=None):
    """Plan a pattern/sequence query: linearized NFA plan + compiled side
    filters + selector over capture columns (reference
    ``StateInputStreamParser.java:76-210`` + ``SelectorParser``)."""
    from siddhi_tpu_torch.core.query.nfa_runtime import NFAQueryRuntime
    from siddhi_tpu_torch.ops.nfa import (
        NFAOutputResolver,
        NFASideResolver,
        NFAStage,
        assign_indexed_captures,
        build_nfa_plan,
    )

    state_stream: StateInputStream = query.input_stream
    dictionary = app_context.string_dictionary
    plan = build_nfa_plan(state_stream, definitions, app_context.nfa_slots)

    if query.selector.select_all or not query.selector.selection_list:
        # `select *` on a pattern expands to every attribute of every
        # pattern element in order (reference SelectorParser over the
        # MetaStateEvent) — sides without captures (pure absent steps)
        # project null columns. Duplicate names reject, as the reference's
        # output-definition validation would.
        seen_refs = {}
        for st in plan.steps:
            for side in st.sides:
                if side.capture is not None and side.capture.ref_id:
                    key = side.capture.ref_id      # one entry per ref
                else:
                    # capture-less (absent) elements are distinct per STEP
                    key = (st.index, side.stream_id)
                seen_refs.setdefault(key, (side.stream_id,
                                           side.capture is not None))
        selection = []
        names = set()
        for ref, (sid, has_cap) in seen_refs.items():
            for attr in definitions[sid].attributes:
                if attr.name in names:
                    raise CompileError(
                        f"query '{query_name}': select * is ambiguous — "
                        f"attribute '{attr.name}' appears in more than one "
                        f"pattern element; use an explicit select list")
                names.add(attr.name)
                expr = (Variable(attribute_name=attr.name, stream_id=ref)
                        if has_cap else Constant(value=None, type=attr.type))
                selection.append(OutputAttribute(rename=attr.name,
                                                 expression=expr))
        query.selector.selection_list = selection
        query.selector.select_all = False

    # size indexed capture storage (e1[i].attr) from every expression that
    # can reference captures: side filters, selections, having, group by
    idx_exprs = [e for st in plan.steps for side in st.sides
                 for e in side.filter_exprs]
    idx_exprs += [oa.expression for oa in query.selector.selection_list]
    if query.selector.having is not None:
        idx_exprs.append(query.selector.having)
    idx_exprs += list(query.selector.group_by_list)
    assign_indexed_captures(plan, idx_exprs)

    for st in plan.steps:
        for side in st.sides:
            if side.filter_exprs:
                resolver = NFASideResolver(side, plan, dictionary)
                conds = [compile_condition(e, resolver) for e in side.filter_exprs]

                def combined(ev, ctx, _conds=conds):
                    r = _conds[0](ev, ctx)
                    for c in _conds[1:]:
                        r = r & c(ev, ctx)
                    return r

                side.cond = combined

    out_resolver = NFAOutputResolver(plan, dictionary)
    output_event_type = (query.output_stream.output_event_type
                         if query.output_stream else "current")
    selector_plan = plan_selector(
        selector=query.selector,
        input_attrs=[],
        resolver=out_resolver,
        output_event_type=output_event_type,
        batch_mode=False,
        dictionary=dictionary,
        app_context=app_context,
    )
    selector_plan.num_keys = app_context.initial_key_capacity

    stream_keyers = {}
    if partition_ctx is not None:
        for sid in plan.stream_ids:
            if sid not in partition_ctx.keyers:
                raise CompileError(
                    f"query '{query_name}': pattern stream '{sid}' is consumed "
                    f"inside a partition but has no partition-with clause")
            stream_keyers[sid] = partition_ctx.keyers[sid]

    # group-by over capture columns: a host keyer runs between the NFA
    # emission and the selector step (GroupByKeyGenerator.java:37)
    out_keyer = None
    if query.selector.group_by_list:
        out_keyer = GroupKeyer([compile_expr(var, out_resolver)
                                for var in query.selector.group_by_list])

    return NFAQueryRuntime(
        name=query_name,
        app_context=app_context,
        stage=NFAStage(plan),
        input_defs={sid: definitions[sid] for sid in plan.stream_ids},
        stream_keyers=stream_keyers,
        selector_plan=selector_plan,
        dictionary=dictionary,
        partition_ctx=partition_ctx,
        out_keyer=out_keyer,
    )


def plan_query(query: Query, query_name: str, app_context,
               definitions: Dict[str, StreamDefinition],
               partition_ctx=None) -> QueryRuntime:
    input_stream = query.input_stream
    if isinstance(query.output_rate, SnapshotOutputRate):
        # snapshot rate limiting requires `insert all events`
        # (QueryParser.java:120-128)
        oet = (query.output_stream.output_event_type
               if query.output_stream else "current")
        if oet != "all":
            raise SiddhiAppValidationException(
                "As the query is performing snapshot rate limiting, it can "
                "only insert 'ALL_EVENTS' but it is inserting "
                f"'{oet.upper()}_EVENTS'!")
    if isinstance(input_stream, StateInputStream):
        return plan_nfa_query(query, query_name, app_context, definitions,
                              partition_ctx)
    if isinstance(input_stream, JoinInputStream):
        return plan_join_query(query, query_name, app_context, definitions,
                               partition_ctx)
    stream_id = input_stream.unique_stream_id
    if stream_id not in definitions:
        raise CompileError(f"query '{query_name}': stream '{stream_id}' is not defined")
    input_def = definitions[stream_id]
    dictionary = app_context.string_dictionary
    resolver = SingleStreamResolver(
        input_def, dictionary, ref_id=input_stream.stream_reference_id, synthetic={})

    partition_keyer = None
    carried_pk = False
    if partition_ctx is not None:
        if input_stream.is_inner_stream:
            carried_pk = True  # '#stream' rows carry their pk id
        elif stream_id in partition_ctx.keyers:
            partition_keyer = partition_ctx.keyers[stream_id]
        elif stream_id in partition_ctx.local_streams:
            # produced by a query in the same partition: its rows carry the
            # producing instance's pk (reference partition flow ids)
            carried_pk = True
        else:
            raise CompileError(
                f"query '{query_name}': stream '{stream_id}' is consumed inside a "
                f"partition but has no partition-with clause and is not an inner stream"
            )

    filters = []
    post_pipeline = []  # after the window: ("f", cond) | ("t", transform)
    window_stage = None
    host_window = None
    batch_mode = False
    transforms = []
    log_stages = []
    ext_def = input_def  # grows as stream functions append attributes

    # string <-> number casts become host transforms feeding the device a
    # synthetic column (rewrites the filter, selection and having ASTs)
    cast_state = {"casts": {}, "attrs": [], "internal": set()}
    seen_window = False
    for handler in input_stream.handlers:
        seen_window = seen_window or isinstance(handler, Window)
        if isinstance(handler, Filter):
            handler.expression = _rewrite_string_casts(
                handler.expression, input_def, resolver, transforms,
                cast_state, dictionary)
            if not seen_window:
                # a post-window `in` probe would bake ingestion-time table
                # rows into buffered rows: unsupported (compile_expr
                # refuses one that survives here)
                handler.expression = _rewrite_in_conditions(
                    handler.expression, input_def,
                    input_stream.stream_reference_id, resolver, app_context,
                    transforms, cast_state)
    if query.selector is not None:
        for sel in query.selector.selection_list or []:
            sel.expression = _rewrite_string_casts(
                sel.expression, input_def, resolver, transforms, cast_state,
                dictionary)
        if query.selector.having is not None:
            query.selector.having = _rewrite_string_casts(
                query.selector.having, input_def, resolver, transforms,
                cast_state, dictionary)
    if cast_state["attrs"]:
        ext_def = StreamDefinition(input_def.id, list(input_def.attributes))
        ext_def.attributes = ext_def.attributes + cast_state["attrs"]

    for handler in input_stream.handlers:
        if isinstance(handler, Filter):
            f = compile_condition(handler.expression, resolver)
            if window_stage is not None or host_window is not None:
                post_pipeline.append(("f", f))
            else:
                filters.append(f)
        elif isinstance(handler, Window):
            if window_stage is not None or host_window is not None:
                raise CompileError("only one #window per stream is allowed")
            if partition_ctx is None:
                window_stage = create_window_stage(handler, ext_def, resolver,
                                                   app_context)
            else:
                window_stage = create_keyed_window_stage(handler, ext_def,
                                                         resolver, app_context)
            batch_mode = window_stage.batch_mode
            if getattr(window_stage, "host_mode", False):
                host_window, window_stage = window_stage, None
        elif isinstance(handler, StreamFunction):
            if window_stage is not None or host_window is not None:
                # post-window stream functions transform the window's
                # emitted rows (their outputs are not buffered)
                post_transforms = []
                log_stage, ext_def = _plan_stream_function_handler(
                    handler, resolver, query_name, filters, post_transforms,
                    ext_def, input_def)
                if log_stage is not None:
                    raise CompileError("#log() after a window is not supported")
                post_pipeline.extend(("t", t) for t in post_transforms)
            else:
                log_stage, ext_def = _plan_stream_function_handler(
                    handler, resolver, query_name, filters, transforms,
                    ext_def, input_def)
                if log_stage is not None:
                    log_stages.append(log_stage)
        else:
            raise CompileError(
                f"query '{query_name}': handler "
                f"'{getattr(handler, 'name', handler)}' is not ported yet")

    if (window_stage is None and host_window is None
            and stream_id in app_context.named_windows):
        # a consumer of a batch-type named window receives its flush
        # chunks: the selector collapses per chunk as it would reading the
        # batch window itself (CustomJoinWindowTestCase
        # testMultipleStreamsToWindow)
        batch_mode = bool(getattr(app_context.named_windows[stream_id].stage,
                                  "batch_mode", False))
    output_event_type = (query.output_stream.output_event_type
                         if query.output_stream else "current")
    if isinstance(query.output_rate, SnapshotOutputRate):
        # snapshot rate limiting turns the selector's batch collapse off
        # (QueryParser.java:221-223)
        batch_mode = False
    selector_plan = plan_selector(
        selector=query.selector,
        input_attrs=[(a.name, a.type) for a in ext_def.attributes],
        resolver=resolver,
        output_event_type=output_event_type,
        dictionary=dictionary,
        app_context=app_context,
        batch_mode=batch_mode,
        internal_names=cast_state["internal"],
    )
    selector_plan.num_keys = app_context.initial_key_capacity

    # host-only stages (the casts' lookup tables, table exists-probes)
    # take the whole transform chain to the host; so does a group key on
    # a transform's output, which the host keyer reads
    host_transforms = bool(cast_state["casts"]) or any(
        getattr(t, "host_only", False) for t in transforms)
    keyer = None
    if selector_plan.group_by:
        fns = []
        for var in query.selector.group_by_list:
            fns.append(compile_expr(var, resolver))
            if getattr(var, "attribute_name", None) in resolver.synthetic:
                host_transforms = True
        keyer = GroupKeyer(fns)

    # fuse window eviction into invertible aggregator deltas when the query
    # shape qualifies (reference query_planner.py:1028-1045)
    if (isinstance(window_stage, LengthWindowStage)
            and not post_pipeline  # the fused stage never materializes emitted rows
            and partition_ctx is None
            and app_context.enable_fusion
            and stream_id not in app_context.named_windows):
        fused = plan_fused_window("length", [window_stage.length],
                                  selector_plan, app_context)
        if fused is not None:
            window_stage = fused

    runtime = QueryRuntime(
        name=query_name,
        app_context=app_context,
        input_definition=input_def,
        filters=filters,
        window_stage=window_stage,
        selector_plan=selector_plan,
        keyer=keyer,
        dictionary=dictionary,
        partition_ctx=partition_ctx,
        partition_keyer=partition_keyer,
        carried_pk=carried_pk,
        transforms=transforms,
        log_stages=log_stages,
        post_pipeline=post_pipeline,
    )
    runtime.host_transforms = host_transforms
    runtime.host_window = host_window
    return runtime
