"""Execution elements: queries, input streams, state (NFA) elements,
selectors, output streams, rate limiting, partitions.

Mirrors reference ``query-api execution/**`` (``query/Query.java``,
``query/input/stream/{Single,Join,State}InputStream.java``,
``query/input/state/*.java``, ``query/selection/Selector.java``,
``query/output/stream/*.java``, ``query/output/ratelimit/*.java``,
``partition/Partition.java``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from siddhi_tpu_torch.query_api.annotations import Annotation
from siddhi_tpu_torch.query_api.expressions import Expression, Variable


# ---------------------------------------------------------------- handlers

@dataclass
class StreamHandler:
    pass


@dataclass
class Filter(StreamHandler):
    expression: Expression


@dataclass
class Window(StreamHandler):
    namespace: str
    name: str
    parameters: List[Expression] = field(default_factory=list)


@dataclass
class StreamFunction(StreamHandler):
    namespace: str
    name: str
    parameters: List[Expression] = field(default_factory=list)


# ------------------------------------------------------------ input streams

@dataclass
class SingleInputStream:
    stream_id: str
    is_inner_stream: bool = False  # '#stream' inside partitions
    is_fault_stream: bool = False  # '!stream'
    stream_reference_id: Optional[str] = None  # `as e1` / pattern ref
    handlers: List[StreamHandler] = field(default_factory=list)

    @property
    def unique_stream_id(self) -> str:
        prefix = "#" if self.is_inner_stream else ("!" if self.is_fault_stream else "")
        return prefix + self.stream_id


class JoinType(enum.Enum):
    JOIN = "join"
    INNER_JOIN = "inner join"
    LEFT_OUTER_JOIN = "left outer join"
    RIGHT_OUTER_JOIN = "right outer join"
    FULL_OUTER_JOIN = "full outer join"


class EventTrigger(enum.Enum):
    LEFT = "left"
    RIGHT = "right"
    ALL = "all"


@dataclass
class JoinInputStream:
    left: SingleInputStream
    right: SingleInputStream
    type: JoinType = JoinType.JOIN
    on_compare: Optional[Expression] = None
    trigger: EventTrigger = EventTrigger.ALL
    within: Optional[Expression] = None  # join with aggregation
    per: Optional[Expression] = None


# -------------------------------------------------------- state (NFA) model

@dataclass
class StateElement:
    # `within <time>` scoped to this element
    within: Optional[int] = None  # milliseconds


@dataclass
class StreamStateElement(StateElement):
    stream: SingleInputStream = None


@dataclass
class AbsentStreamStateElement(StreamStateElement):
    # `not <stream> for <time>`
    waiting_time: Optional[int] = None  # milliseconds


@dataclass
class NextStateElement(StateElement):
    state: StateElement = None
    next: StateElement = None


@dataclass
class EveryStateElement(StateElement):
    state: StateElement = None


@dataclass
class CountStateElement(StateElement):
    ANY = -1
    state: StreamStateElement = None
    min_count: int = -1
    max_count: int = -1


@dataclass
class LogicalStateElement(StateElement):
    stream1: StreamStateElement = None
    type: str = "and"  # 'and' | 'or'
    stream2: StreamStateElement = None


class StateInputStreamType(enum.Enum):
    PATTERN = "pattern"
    SEQUENCE = "sequence"


@dataclass
class StateInputStream:
    state_type: StateInputStreamType
    state_element: StateElement = None
    within: Optional[int] = None  # milliseconds, whole-pattern `within`

    @property
    def all_stream_ids(self) -> List[str]:
        out: List[str] = []

        def walk(el):
            if isinstance(el, StreamStateElement):
                out.append(el.stream.stream_id)
            elif isinstance(el, NextStateElement):
                walk(el.state)
                walk(el.next)
            elif isinstance(el, EveryStateElement):
                walk(el.state)
            elif isinstance(el, CountStateElement):
                walk(el.state)
            elif isinstance(el, LogicalStateElement):
                walk(el.stream1)
                walk(el.stream2)

        walk(self.state_element)
        return out


# ----------------------------------------------------------------- selector

@dataclass
class OutputAttribute:
    rename: Optional[str]
    expression: Expression

    @property
    def name(self) -> str:
        if self.rename:
            return self.rename
        if isinstance(self.expression, Variable):
            return self.expression.attribute_name
        raise ValueError("projection expression needs an 'as' rename")


@dataclass
class OrderByAttribute:
    variable: Variable
    order: str = "asc"  # 'asc' | 'desc'


@dataclass
class Selector:
    selection_list: List[OutputAttribute] = field(default_factory=list)
    select_all: bool = False  # `select *` (or no select clause)
    group_by_list: List[Variable] = field(default_factory=list)
    having: Optional[Expression] = None
    order_by_list: List[OrderByAttribute] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None


# ------------------------------------------------------------ output stream

@dataclass
class OutputStream:
    target_id: str = ""
    # Which event types flow to output: 'current', 'expired', 'all'
    # (reference OutputStream.OutputEventType).
    output_event_type: str = "current"


@dataclass
class InsertIntoStream(OutputStream):
    is_inner_stream: bool = False
    is_fault_stream: bool = False


@dataclass
class DeleteStream(OutputStream):
    on_delete: Expression = None


@dataclass
class SetAttribute:
    table_variable: Variable = None
    assignment: Expression = None


@dataclass
class UpdateSet:
    set_attributes: List[SetAttribute] = field(default_factory=list)


@dataclass
class UpdateStream(OutputStream):
    on_update: Expression = None
    update_set: Optional[UpdateSet] = None


@dataclass
class UpdateOrInsertStream(OutputStream):
    on_update: Expression = None
    update_set: Optional[UpdateSet] = None


@dataclass
class ReturnStream(OutputStream):
    """On-demand / store-query `return` output."""


# ------------------------------------------------------------- rate limits

@dataclass
class OutputRate:
    pass


@dataclass
class EventOutputRate(OutputRate):
    value: int = 1
    type: str = "all"  # 'all' | 'first' | 'last'


@dataclass
class TimeOutputRate(OutputRate):
    value: int = 1000  # milliseconds
    type: str = "all"


@dataclass
class SnapshotOutputRate(OutputRate):
    value: int = 1000  # milliseconds


# ----------------------------------------------------------------- queries

@dataclass
class Query:
    input_stream: object = None  # Single/Join/State InputStream
    selector: Selector = field(default_factory=Selector)
    output_stream: OutputStream = None
    output_rate: Optional[OutputRate] = None
    annotations: List[Annotation] = field(default_factory=list)

    @property
    def name(self) -> Optional[str]:
        for a in self.annotations:
            if a.name.lower() == "info":
                return a.element("name")
        return None


@dataclass
class OnDemandQuery:
    """Ad-hoc query against a table/window/aggregation (reference
    ``query-api execution/query/OnDemandQuery.java`` / StoreQuery)."""

    input_store: object = None  # InputStore
    selector: Selector = field(default_factory=Selector)
    output_stream: OutputStream = None
    type: str = "find"  # find | insert | delete | update | update_or_insert


@dataclass
class InputStore:
    store_id: str = ""
    store_reference_id: Optional[str] = None
    on_condition: Optional[Expression] = None
    within: Optional[Expression] = None
    per: Optional[Expression] = None


# --------------------------------------------------------------- partitions

@dataclass
class PartitionType:
    stream_id: str = ""


@dataclass
class ValuePartitionType(PartitionType):
    expression: Expression = None


@dataclass
class RangeCondition:
    partition_key: str = ""
    condition: Expression = None


@dataclass
class RangePartitionType(PartitionType):
    conditions: List[RangeCondition] = field(default_factory=list)


@dataclass
class Partition:
    partition_types: List[PartitionType] = field(default_factory=list)
    queries: List[Query] = field(default_factory=list)
    annotations: List[Annotation] = field(default_factory=list)
