"""SiddhiAppRuntime: one assembled app — junctions, queries, callbacks.

Counterpart of ``siddhi_tpu/core/app_runtime.py``, reduced to what the
port runs: stream definitions, queries and value partitions, stream and
query callbacks, custom extension functions and ``define function``
scripts, the set-element metadata of OBJECT attributes,
``@app:name``/``@app:playback``/``@app:precision``, ``@Async`` and
``@OnError`` streams, ``@source``/``@sink`` transports, the dispatch
pipeline and the ingest pack pool, and the ``siddhi_tpu.*`` config
knobs. Tables, named windows, triggers, incremental aggregations and
``@purge`` are not ported yet and raise ``CompileError`` naming
themselves, so an app never runs with a part silently missing.

The app starts at ``start()`` or at its first send: @Async workers, the
ingest pool, sinks' connections and sources (each connecting with retry
on its own thread). ``shutdown`` drains the pipeline, stops sources and
workers (each delivers what its queue holds first), then drops the
device state.
"""

from __future__ import annotations

import threading
from typing import Dict, List

from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException
from siddhi_tpu_torch.core.context import SiddhiAppContext, SiddhiContext
from siddhi_tpu_torch.core.plan.query_planner import plan_query
from siddhi_tpu_torch.core.query.callback import QueryCallback
from siddhi_tpu_torch.core.query.runtime import QueryRuntime
from siddhi_tpu_torch.core.stream.input.input_handler import InputHandler, InputManager
from siddhi_tpu_torch.core.stream.junction import StreamJunction
from siddhi_tpu_torch.core.stream.output.stream_callback import StreamCallback
from siddhi_tpu_torch.ops.expressions import CompileError, set_active_extensions
from siddhi_tpu_torch.query_api.annotations import find_annotation, find_annotations
from siddhi_tpu_torch.query_api.definitions import Attribute, AttrType, StreamDefinition
from siddhi_tpu_torch.query_api.execution import (
    InsertIntoStream,
    Partition,
    Query,
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


def _default_app_name(siddhi_app: SiddhiApp) -> str:
    import hashlib

    return "siddhi-app-" + hashlib.md5(repr(siddhi_app).encode()).hexdigest()[:12]


class SiddhiAppRuntime:
    def __init__(self, siddhi_app: SiddhiApp, siddhi_context: SiddhiContext):
        self.siddhi_app = siddhi_app
        self.name = siddhi_app.name or _default_app_name(siddhi_app)
        self.app_context = SiddhiAppContext(siddhi_context, self.name)
        self._barrier = threading.RLock()
        self.stream_definitions: Dict[str, StreamDefinition] = dict(
            siddhi_app.stream_definitions)
        self.junctions: Dict[str, StreamJunction] = {}
        self.query_runtimes: Dict[str, QueryRuntime] = {}
        self.partition_contexts: List = []
        self.source_runtimes: List = []
        self.sink_runtimes: List = []
        self._started = False

        for what, defs in (("tables", siddhi_app.table_definitions),
                           ("named windows", siddhi_app.window_definitions),
                           ("triggers", siddhi_app.trigger_definitions),
                           ("incremental aggregations",
                            siddhi_app.aggregation_definitions)):
            if defs:
                raise CompileError(f"{what} are not ported to siddhi_tpu_torch yet")
        if siddhi_app.app_annotation("playback") is not None:
            self.app_context.timestamp_generator.playback = True
        prec = siddhi_app.app_annotation("precision")
        if prec is not None:
            v = (prec.element() or "").lower()
            if v not in ("exact", "fast"):
                raise SiddhiAppValidationException(
                    "@app:precision must be 'exact' or 'fast'")
            self.app_context.precision = v

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

    # ------------------------------------------------------------ assembly

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
        from siddhi_tpu_torch.core.partition import PartitionContext, ValuePartitionKeyer
        from siddhi_tpu_torch.core.plan.resolvers import SingleStreamResolver
        from siddhi_tpu_torch.ops.expressions import compile_expr

        if find_annotation(partition.annotations or [], "purge") is not None:
            raise CompileError("@purge is not ported to siddhi_tpu_torch yet")
        pctx = PartitionContext(p_index)
        self.partition_contexts.append(pctx)
        for ptype in partition.partition_types:
            sid = ptype.stream_id
            if sid not in self.stream_definitions:
                raise SiddhiAppValidationException(
                    f"partition with (... of {sid}): stream '{sid}' is not defined")
            if not isinstance(ptype, ValuePartitionType):
                raise CompileError(
                    "range partitions are not ported to siddhi_tpu_torch yet")
            resolver = SingleStreamResolver(
                self.stream_definitions[sid], self.app_context.string_dictionary)
            fn, t = compile_expr(ptype.expression, resolver)
            pctx.keyers[sid] = ValuePartitionKeyer([(fn, t)], pctx.keyspace)
        for query in partition.queries:
            q_index += 1
            self._add_query(query, q_index, partition_ctx=pctx)
        return q_index

    def _add_query(self, query: Query, index: int, partition_ctx=None):
        query_name = query.name or f"query_{index}"
        runtime = plan_query(query, query_name, self.app_context,
                             dict(self.stream_definitions),
                             partition_ctx=partition_ctx)
        out = query.output_stream
        if not isinstance(out, InsertIntoStream) or out.is_inner_stream:
            raise CompileError(
                f"query '{query_name}': only 'insert into <stream>' outputs "
                f"are ported to siddhi_tpu_torch yet")
        target = out.target_id
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
        self.junctions[query.input_stream.unique_stream_id].subscribe(runtime)
        self.query_runtimes[query_name] = runtime

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

    def start(self):
        """Start @Async workers, the ingest pool, sinks and sources (also
        done by the first send)."""
        with self._barrier:   # a lazy start can race concurrent first sends
            if self._started:
                return
            self._started = True
            ctx = self.app_context
            if ctx.ingest_pool > 0 and ctx.ingest_pack_pool is None:
                from siddhi_tpu_torch.core.stream.input.pack_pool import IngestPackPool

                ctx.ingest_pack_pool = IngestPackPool(
                    ctx, workers=ctx.ingest_pool, split_rows=ctx.ingest_split)
            for j in self.junctions.values():
                j.start_processing()
            for sr in self.sink_runtimes:
                sr.connect()
            for sr in self.source_runtimes:
                # connect with retry/backoff off-thread (Source.java:155-185)
                threading.Thread(target=sr.connect_with_retry, daemon=True).start()

    def shutdown(self):
        import logging

        ctx = self.app_context
        ctx.stopped = True
        if ctx.completion_pump.has_pending:
            # batches still riding the pipeline emit before teardown
            try:
                ctx.completion_pump.flush()
            except RuntimeError:
                logging.getLogger(__name__).exception(
                    "pipeline flush failed during shutdown")
        for sr in self.source_runtimes:
            sr.shutdown()
        for j in self.junctions.values():
            # an @Async worker delivers its queue, flushes, then exits
            j.stop_processing()
        for sr in self.sink_runtimes:
            sr.shutdown()
        if ctx.ingest_pack_pool is not None:
            # after the workers stopped: no pack can be in flight
            ctx.ingest_pack_pool.shutdown()
            ctx.ingest_pack_pool = None
        with self._barrier:
            # drop device state so the app's memory is released now
            for q in self.query_runtimes.values():
                q._state = None
                q._step = None
                q._staging = None
