"""Data-only query object model ("IR").

Mirrors the role of the reference's ``modules/siddhi-query-api`` (pure-data
AST consumed by the runtime parsers; reference ``SiddhiApp.java``,
``execution/query/Query.java``): the SiddhiQL compiler produces these
objects, and the planner lowers them into jitted step functions. Every class
is a plain dataclass so apps can also be built programmatically (the
reference exposes the same dual text/programmatic surface).
"""

from siddhi_tpu_torch.query_api.annotations import Annotation
from siddhi_tpu_torch.query_api.definitions import (
    Attribute,
    AttrType,
    StreamDefinition,
    TableDefinition,
    WindowDefinition,
    TriggerDefinition,
    AggregationDefinition,
    FunctionDefinition,
    TimePeriod,
)
from siddhi_tpu_torch.query_api.expressions import (
    Expression,
    Constant,
    TimeConstant,
    Variable,
    Add,
    Subtract,
    Multiply,
    Divide,
    Mod,
    Compare,
    And,
    Or,
    Not,
    IsNull,
    InOp,
    AttributeFunction,
)
from siddhi_tpu_torch.query_api.execution import (
    Query,
    OnDemandQuery,
    Partition,
    PartitionType,
    ValuePartitionType,
    RangePartitionType,
    SingleInputStream,
    JoinInputStream,
    StateInputStream,
    StreamHandler,
    Filter,
    Window,
    StreamFunction,
    StateElement,
    StreamStateElement,
    AbsentStreamStateElement,
    NextStateElement,
    EveryStateElement,
    CountStateElement,
    LogicalStateElement,
    Selector,
    OutputAttribute,
    OrderByAttribute,
    OutputStream,
    InsertIntoStream,
    DeleteStream,
    UpdateStream,
    UpdateOrInsertStream,
    UpdateSet,
    SetAttribute,
    ReturnStream,
    OutputRate,
    EventOutputRate,
    TimeOutputRate,
    SnapshotOutputRate,
)
from siddhi_tpu_torch.query_api.siddhi_app import SiddhiApp
