"""Top-level SiddhiApp IR container.

Mirrors reference ``query-api SiddhiApp.java`` — holds all definitions and
execution elements in declaration order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from siddhi_tpu_torch.query_api.annotations import Annotation
from siddhi_tpu_torch.query_api.definitions import (
    AggregationDefinition,
    AttrType,
    FunctionDefinition,
    StreamDefinition,
    TableDefinition,
    TriggerDefinition,
    WindowDefinition,
)
from siddhi_tpu_torch.query_api.execution import Partition, Query


@dataclass
class SiddhiApp:
    annotations: List[Annotation] = field(default_factory=list)
    stream_definitions: Dict[str, StreamDefinition] = field(default_factory=dict)
    table_definitions: Dict[str, TableDefinition] = field(default_factory=dict)
    window_definitions: Dict[str, WindowDefinition] = field(default_factory=dict)
    trigger_definitions: Dict[str, TriggerDefinition] = field(default_factory=dict)
    aggregation_definitions: Dict[str, AggregationDefinition] = field(default_factory=dict)
    function_definitions: Dict[str, FunctionDefinition] = field(default_factory=dict)
    # Queries and partitions in declaration order.
    execution_elements: List[object] = field(default_factory=list)

    @property
    def name(self) -> Optional[str]:
        # `@app:name('X')` is stored as Annotation(name='app:name',
        # elements=[(None, 'X')]) (cf. reference SiddhiAppParser.java:91).
        for a in self.annotations:
            if a.name.lower() in ("app:name", "name"):
                return a.element(None) or a.element("name")
        return None

    def app_annotation(self, key: str) -> Optional[Annotation]:
        """Find `@app:<key>(...)` (e.g. playback, async, statistics)."""
        for a in self.annotations:
            if a.name.lower() == f"app:{key.lower()}":
                return a
        return None

    @property
    def queries(self) -> List[Query]:
        return [e for e in self.execution_elements if isinstance(e, Query)]

    @property
    def partitions(self) -> List[Partition]:
        return [e for e in self.execution_elements if isinstance(e, Partition)]

    def _check_duplicate(self, d, kind: str):
        """Same-id redefinitions must be attribute-identical; any same-id
        definition of a DIFFERENT kind conflicts (reference
        ``AbstractDefinition.checkEquivalency`` via the reference app runtime's
        DuplicateDefinitionException paths)."""
        from siddhi_tpu_torch.compiler.errors import DuplicateDefinitionException

        pools = {"stream": self.stream_definitions,
                 "table": self.table_definitions,
                 "window": self.window_definitions,
                 "trigger": self.trigger_definitions,
                 "aggregation": self.aggregation_definitions}
        for k, pool in pools.items():
            prev = pool.get(d.id)
            if prev is None:
                continue
            if k != kind:
                if {k, kind} == {"stream", "trigger"}:
                    # a trigger IS a `(triggered_time long)` stream — the id
                    # may collide with a stream of exactly that shape
                    # (TriggerTestCase testQuery3 vs testQuery4)
                    sdef = prev if k == "stream" else d
                    attrs = [(a.name, a.type)
                             for a in getattr(sdef, "attributes", [])]
                    if attrs == [("triggered_time", AttrType.LONG)]:
                        continue
                    raise DuplicateDefinitionException(
                        f"trigger '{d.id}' collides with a stream of a "
                        f"different attribute list")
                raise DuplicateDefinitionException(
                    f"'{d.id}' is already defined as a {k}")
            prev_attrs = [(a.name, a.type)
                          for a in getattr(prev, "attributes", [])]
            new_attrs = [(a.name, a.type)
                         for a in getattr(d, "attributes", [])]
            if prev_attrs != new_attrs:
                raise DuplicateDefinitionException(
                    f"{kind} '{d.id}' is already defined with a different "
                    f"attribute list")

    def define_stream(self, d: StreamDefinition) -> "SiddhiApp":
        self._check_duplicate(d, "stream")
        self.stream_definitions[d.id] = d
        return self

    def define_table(self, d: TableDefinition) -> "SiddhiApp":
        self._check_duplicate(d, "table")
        self.table_definitions[d.id] = d
        return self

    def define_window(self, d: WindowDefinition) -> "SiddhiApp":
        self._check_duplicate(d, "window")
        self.window_definitions[d.id] = d
        return self

    def define_trigger(self, d: TriggerDefinition) -> "SiddhiApp":
        self._check_duplicate(d, "trigger")
        self.trigger_definitions[d.id] = d
        return self

    def define_aggregation(self, d: AggregationDefinition) -> "SiddhiApp":
        self._check_duplicate(d, "aggregation")
        self.aggregation_definitions[d.id] = d
        return self

    def add_query(self, q: Query) -> "SiddhiApp":
        self.execution_elements.append(q)
        return self

    def add_partition(self, p: Partition) -> "SiddhiApp":
        self.execution_elements.append(p)
        return self
