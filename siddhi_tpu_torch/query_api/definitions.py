"""Definitions: streams, tables, windows, triggers, aggregations, functions.

Mirrors reference ``query-api definition/*.java`` (``StreamDefinition``,
``TableDefinition``, ``WindowDefinition``, ``AggregationDefinition``,
``TriggerDefinition``, ``FunctionDefinition``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from siddhi_tpu_torch.query_api.annotations import Annotation


class AttrType(enum.Enum):
    STRING = "string"
    INT = "int"
    LONG = "long"
    FLOAT = "float"
    DOUBLE = "double"
    BOOL = "bool"
    OBJECT = "object"


@dataclass
class Attribute:
    name: str
    type: AttrType


@dataclass
class AbstractDefinition:
    id: str
    attributes: List[Attribute] = field(default_factory=list)
    annotations: List[Annotation] = field(default_factory=list)

    def attribute_names(self) -> List[str]:
        return [a.name for a in self.attributes]

    def attribute(self, name: str) -> Attribute:
        for a in self.attributes:
            if a.name == name:
                return a
        raise KeyError(f"attribute '{name}' not found in '{self.id}'")

    def attribute_position(self, name: str) -> int:
        for i, a in enumerate(self.attributes):
            if a.name == name:
                return i
        raise KeyError(f"attribute '{name}' not found in '{self.id}'")


@dataclass
class StreamDefinition(AbstractDefinition):
    pass


@dataclass
class TableDefinition(AbstractDefinition):
    pass


@dataclass
class WindowDefinition(AbstractDefinition):
    # The window handler, e.g. Window("", "time", [TimeConstant(...)]).
    window: object = None
    # OutputEventType: 'current', 'expired', 'all' (reference
    # WindowDefinition.java OutputEventType); default in Siddhi: ALL_EVENTS.
    output_event_type: str = "all"


@dataclass
class TriggerDefinition:
    id: str
    # Exactly one of: at_every (ms), cron expression, or 'start'.
    at_every: Optional[int] = None
    cron: Optional[str] = None
    at_start: bool = False
    annotations: List[Annotation] = field(default_factory=list)


class Duration(enum.Enum):
    SECONDS = "sec"
    MINUTES = "min"
    HOURS = "hour"
    DAYS = "day"
    MONTHS = "month"
    YEARS = "year"


@dataclass
class TimePeriod:
    """`aggregate every sec ... year` — range or interval of durations.

    Reference ``query-api aggregation/TimePeriod.java``.
    """

    operator: str = "range"  # 'range' or 'interval'
    durations: List[Duration] = field(default_factory=list)


@dataclass
class AggregationDefinition:
    """`define aggregation` — incremental time-series aggregation.

    Reference ``query-api definition/AggregationDefinition.java``.
    """

    id: str = ""
    input_stream: object = None  # SingleInputStream (usually)
    selector: object = None  # Selector
    aggregate_attribute: object = None  # Variable for `aggregate by <attr>`
    time_period: Optional[TimePeriod] = None
    annotations: List[Annotation] = field(default_factory=list)


@dataclass
class FunctionDefinition:
    """`define function name[lang] return type { body }`.

    Reference ``query-api definition/FunctionDefinition.java``.
    """

    id: str = ""
    language: str = ""
    return_type: Optional[AttrType] = None
    body: str = ""
