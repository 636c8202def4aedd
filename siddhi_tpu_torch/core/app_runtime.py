"""SiddhiAppRuntime: one assembled app — junctions, queries, callbacks.

Counterpart of ``siddhi_tpu/core/app_runtime.py``, reduced to what this
slice runs: stream definitions, queries and value partitions, stream
callbacks, ``@app:name``/``@app:playback``/``@app:precision`` and the
``siddhi_tpu.*`` config knobs. Tables, named windows, triggers,
incremental aggregations, functions, sources/sinks, ``@Async`` and
``@purge`` are not ported yet and raise ``CompileError`` naming
themselves, so an app never runs with a part silently missing.
"""

from __future__ import annotations

import threading
from typing import Dict, List

from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException
from siddhi_tpu_torch.core.context import SiddhiAppContext, SiddhiContext
from siddhi_tpu_torch.core.plan.query_planner import plan_query
from siddhi_tpu_torch.core.query.runtime import QueryRuntime
from siddhi_tpu_torch.core.stream.input.input_handler import InputHandler, InputManager
from siddhi_tpu_torch.core.stream.junction import StreamJunction
from siddhi_tpu_torch.core.stream.output.stream_callback import StreamCallback
from siddhi_tpu_torch.ops.expressions import CompileError
from siddhi_tpu_torch.query_api.annotations import find_annotation
from siddhi_tpu_torch.query_api.definitions import Attribute, StreamDefinition
from siddhi_tpu_torch.query_api.execution import (
    InsertIntoStream,
    Partition,
    Query,
    ValuePartitionType,
)
from siddhi_tpu_torch.query_api.siddhi_app import SiddhiApp


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

        for what, defs in (("tables", siddhi_app.table_definitions),
                           ("named windows", siddhi_app.window_definitions),
                           ("triggers", siddhi_app.trigger_definitions),
                           ("incremental aggregations",
                            siddhi_app.aggregation_definitions),
                           ("functions", siddhi_app.function_definitions)):
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

        apply_app_knobs(siddhi_context.config_manager, self.app_context)

        for sdef in self.stream_definitions.values():
            for ann in ("async", "OnError", "source", "sink"):
                if find_annotation(sdef.annotations or [], ann) is not None:
                    raise CompileError(
                        f"stream '{sdef.id}': @{ann} is not ported to "
                        f"siddhi_tpu_torch yet")
            self.junctions[sdef.id] = StreamJunction(sdef, self.app_context)

        self.input_manager = InputManager(self.app_context, self.junctions,
                                          self._barrier)

        q_index = 0
        p_index = 0
        for element in siddhi_app.execution_elements:
            if isinstance(element, Query):
                q_index += 1
                self._add_query(element, q_index)
            elif isinstance(element, Partition):
                p_index += 1
                q_index = self._add_partition(element, p_index, q_index)

    # ------------------------------------------------------------ assembly

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
            self.junctions[target] = StreamJunction(sdef, self.app_context)
        else:
            existing = self.stream_definitions[target]
            dattrs = [(a.name, a.type) for a in existing.attributes]
            if list(runtime.output_attrs) != dattrs:
                raise SiddhiAppValidationException(
                    f"query '{query_name}' inserts {list(runtime.output_attrs)} "
                    f"into stream '{target}' defined as {dattrs}")
        runtime.output_junction = self.junctions[target]
        self.junctions[query.input_stream.unique_stream_id].subscribe(runtime)
        self.query_runtimes[query_name] = runtime

    # ------------------------------------------------------------- API

    def get_input_handler(self, stream_id: str) -> InputHandler:
        return self.input_manager.get_input_handler(stream_id)

    def add_callback(self, id_: str, callback):
        """addCallback(streamId, StreamCallback)."""
        if not isinstance(callback, StreamCallback):
            raise TypeError(
                f"unsupported callback type {type(callback)} (query callbacks "
                f"are not ported yet)")
        if id_ not in self.junctions:
            raise SiddhiAppValidationException(f"stream '{id_}' is not defined")
        callback.stream_id = id_
        self.junctions[id_].subscribe(callback)

    def start(self):
        """Nothing to start in the ported slice: it has no triggers,
        sources or @Async workers. Kept so reference call sites run."""
    def shutdown(self):
        with self._barrier:
            self.app_context.stopped = True
            # drop device state so the app's memory is released now
            for q in self.query_runtimes.values():
                q._state = None
                q._step = None
