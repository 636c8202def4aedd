"""Query planner: query-api Query -> QueryRuntime.

Counterpart of ``plan_query`` in ``siddhi_tpu/core/plan/query_planner.py``
for the shapes the port runs: a single input stream with filters and at
most one length window (keyed inside a partition, per query outside), a
selector with every aggregator, ``group by``, ``having``, ``order by``
and ``limit``/``offset``, and function calls anywhere an expression
stands. An unpartitioned length window whose aggregators are all
invertible takes the fused stage (``ops/fused_agg.py``), as the reference
decides it. Joins, patterns, stream functions, casts between strings and
numbers (host parse stages in the reference), ``in <table>`` probes and
the other windows are not ported yet and raise ``CompileError`` naming
the construct.
"""

from __future__ import annotations

from typing import Dict

from siddhi_tpu_torch.core.plan.resolvers import SingleStreamResolver
from siddhi_tpu_torch.core.plan.selector_plan import plan_selector
from siddhi_tpu_torch.core.query.runtime import GroupKeyer, QueryRuntime
from siddhi_tpu_torch.ops.expressions import CompileError, compile_condition, compile_expr
from siddhi_tpu_torch.ops.fused_agg import plan_fused_window
from siddhi_tpu_torch.ops.keyed_windows import create_keyed_window_stage
from siddhi_tpu_torch.ops.windows import LengthWindowStage, create_window_stage
from siddhi_tpu_torch.query_api.definitions import StreamDefinition
from siddhi_tpu_torch.query_api.execution import (
    Filter,
    Query,
    SingleInputStream,
    Window,
)


def plan_query(query: Query, query_name: str, app_context,
               definitions: Dict[str, StreamDefinition],
               partition_ctx=None) -> QueryRuntime:
    input_stream = query.input_stream
    if query.output_rate is not None:
        raise CompileError(
            f"query '{query_name}': output rate limiting is not ported yet")
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
    if partition_ctx is not None:
        if input_stream.is_inner_stream or stream_id not in partition_ctx.keyers:
            raise CompileError(
                f"query '{query_name}': only partitioned outer streams are "
                f"ported as partition inputs (stream '{stream_id}')")
        partition_keyer = partition_ctx.keyers[stream_id]

    filters = []
    post_filters = []   # after the window: mask emitted rows
    window_stage = None
    for handler in input_stream.handlers:
        if isinstance(handler, Filter):
            f = compile_condition(handler.expression, resolver)
            (post_filters if window_stage is not None else filters).append(f)
        elif isinstance(handler, Window):
            if window_stage is not None:
                raise CompileError("only one #window per stream is allowed")
            if partition_ctx is None:
                window_stage = create_window_stage(handler, input_def, resolver,
                                                   app_context)
            else:
                window_stage = create_keyed_window_stage(handler, input_def,
                                                         resolver, app_context)
        else:
            raise CompileError(
                f"query '{query_name}': stream function "
                f"'{getattr(handler, 'name', handler)}' is not ported yet")

    output_event_type = (query.output_stream.output_event_type
                         if query.output_stream else "current")
    selector_plan = plan_selector(
        selector=query.selector,
        input_attrs=[(a.name, a.type) for a in input_def.attributes],
        resolver=resolver,
        output_event_type=output_event_type,
        dictionary=dictionary,
        app_context=app_context,
    )
    selector_plan.num_keys = app_context.initial_key_capacity

    keyer = None
    if selector_plan.group_by:
        keyer = GroupKeyer([compile_expr(var, resolver)
                            for var in query.selector.group_by_list])

    # fuse window eviction into invertible aggregator deltas when the query
    # shape qualifies (reference query_planner.py:1028-1045)
    if (isinstance(window_stage, LengthWindowStage)
            and not post_filters  # the fused stage never materializes emitted rows
            and partition_ctx is None
            and app_context.enable_fusion):
        fused = plan_fused_window("length", [window_stage.length],
                                  selector_plan, app_context)
        if fused is not None:
            window_stage = fused

    return QueryRuntime(
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
        post_filters=post_filters,
    )
