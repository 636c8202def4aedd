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
(``ops/fused_agg.py``), as the reference decides it. Joins, patterns and
``in <table>`` probes are not ported yet and raise ``CompileError`` naming
the construct.
"""

from __future__ import annotations

from typing import Dict

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
    Filter,
    Query,
    SingleInputStream,
    SnapshotOutputRate,
    StreamFunction,
    Window,
)
from siddhi_tpu_torch.query_api.expressions import (
    AttributeFunction,
    Constant,
    Expression,
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
    if not isinstance(input_stream, SingleInputStream):
        raise CompileError(
            f"query '{query_name}': {type(input_stream).__name__} inputs "
            f"(joins, patterns, sequences) are not ported to "
            f"siddhi_tpu_torch yet")
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
    for handler in input_stream.handlers:
        if isinstance(handler, Filter):
            handler.expression = _rewrite_string_casts(
                handler.expression, input_def, resolver, transforms,
                cast_state, dictionary)
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

    # host-only stages (the casts' lookup tables) take the whole transform
    # chain to the host; so does a group key on a transform's output,
    # which the host keyer reads
    host_transforms = bool(cast_state["casts"])
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
            and app_context.enable_fusion):
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
