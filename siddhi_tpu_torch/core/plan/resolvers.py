"""Variable resolvers: map query-api Variables to batch column keys.

Counterpart of ``siddhi_tpu/core/plan/resolvers.py`` (copied).

The analog of meta-event attribute position resolution in the reference
(``QueryParserHelper.reduceMetaComplexEvent/updateVariablePosition``,
``MetaStreamEvent.java:34-41``) — but instead of (stream, segment, index)
positions, attributes resolve to named columns of the batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from siddhi_tpu_torch.core.event import StringDictionary
from siddhi_tpu_torch.ops.expressions import ColumnRef, CompileError, Resolver
from siddhi_tpu_torch.query_api.definitions import AbstractDefinition, AttrType
from siddhi_tpu_torch.query_api.expressions import Variable


class SingleStreamResolver(Resolver):
    """Resolve against one stream definition (+ synthetic columns such as
    aggregator outputs), with an app-global string dictionary."""

    def __init__(
        self,
        definition: AbstractDefinition,
        dictionary: StringDictionary,
        ref_id: Optional[str] = None,
        prefix: str = "",
        synthetic: Optional[Dict[str, AttrType]] = None,
    ):
        self.definition = definition
        self.dictionary = dictionary
        self.ref_id = ref_id
        self.prefix = prefix
        self.synthetic = synthetic or {}

    def accepts_stream(self, stream_id: Optional[str]) -> bool:
        return stream_id is None or stream_id == self.definition.id or stream_id == self.ref_id

    def resolve(self, var: Variable) -> ColumnRef:
        if var.attribute_name in self.synthetic:
            return ColumnRef(var.attribute_name, self.synthetic[var.attribute_name])
        if not self.accepts_stream(var.stream_id):
            raise CompileError(
                f"'{var.stream_id}.{var.attribute_name}' does not match stream "
                f"'{self.definition.id}'"
            )
        attr = self.definition.attribute(var.attribute_name)
        return ColumnRef(self.prefix + attr.name, attr.type)

    def encode_string(self, s: str) -> int:
        return self.dictionary.encode(s)


class OutputColsResolver(Resolver):
    """Resolve against the selector's output columns (for `having`,
    `order by`), falling back to another resolver for raw input attrs —
    matching the reference where having executes on the projected event."""

    def __init__(self, outputs: List[Tuple[str, AttrType]], dictionary: StringDictionary,
                 fallback: Optional[Resolver] = None):
        self.outputs = dict(outputs)
        self.dictionary = dictionary
        self.fallback = fallback

    def resolve(self, var: Variable) -> ColumnRef:
        if var.stream_id is None and var.attribute_name in self.outputs:
            return ColumnRef(var.attribute_name, self.outputs[var.attribute_name])
        if self.fallback is not None:
            return self.fallback.resolve(var)
        raise CompileError(f"unknown attribute '{var.attribute_name}' in having/order by")

    def encode_string(self, s: str) -> int:
        return self.dictionary.encode(s)
