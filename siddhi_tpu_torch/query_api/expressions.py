"""Expression AST.

Mirrors reference ``query-api expression/**`` (``Expression.java``,
``condition/{And,Or,Not,Compare,In,IsNull}.java``,
``math/{Add,Subtract,Multiply,Divide,Mod}.java``, ``constant/*.java``,
``Variable.java``, ``AttributeFunction.java``). Data-only: lowering to
torch lives in ``siddhi_tpu_torch.ops.expressions``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from siddhi_tpu_torch.query_api.definitions import AttrType


class Expression:
    pass


@dataclass
class Constant(Expression):
    value: object
    type: AttrType


@dataclass
class TimeConstant(Expression):
    """A `5 sec` / `1 min` literal, normalized to milliseconds (LONG)."""

    value: int  # milliseconds

    @property
    def type(self) -> AttrType:
        return AttrType.LONG


@dataclass
class Variable(Expression):
    attribute_name: str
    stream_id: Optional[str] = None
    # For pattern/sequence references like e1[0].price / e1[last].price.
    stream_index: Optional[object] = None  # int | 'last'
    function_id: Optional[str] = None  # aggregation ref inside `within`/`per`


@dataclass
class Add(Expression):
    left: Expression
    right: Expression


@dataclass
class Subtract(Expression):
    left: Expression
    right: Expression


@dataclass
class Multiply(Expression):
    left: Expression
    right: Expression


@dataclass
class Divide(Expression):
    left: Expression
    right: Expression


@dataclass
class Mod(Expression):
    left: Expression
    right: Expression


@dataclass
class Compare(Expression):
    left: Expression
    operator: str  # '<', '<=', '>', '>=', '==', '!='
    right: Expression


@dataclass
class And(Expression):
    left: Expression
    right: Expression


@dataclass
class Or(Expression):
    left: Expression
    right: Expression


@dataclass
class Not(Expression):
    expression: Expression


@dataclass
class IsNull(Expression):
    expression: Optional[Expression] = None
    # `e1 is null` for pattern stream-state null checks:
    stream_id: Optional[str] = None
    stream_index: Optional[object] = None


@dataclass
class InOp(Expression):
    expression: Expression
    source_id: str  # table/window to check membership in


@dataclass
class AttributeFunction(Expression):
    namespace: str
    name: str
    parameters: List[Expression] = field(default_factory=list)
