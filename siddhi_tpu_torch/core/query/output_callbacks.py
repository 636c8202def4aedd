"""Table output callbacks: insert/delete/update/update-or-insert actions.

Counterpart of ``siddhi_tpu/core/query/output_callbacks.py``, the mirror
of reference ``query/output/callback/{InsertIntoTableCallback,
DeleteTableCallback,UpdateTableCallback,UpdateOrInsertTableCallback}.java``:
the query's output chunk becomes one columnar batch applied to the table
in one batched operation.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from siddhi_tpu_torch.core.event import Event, HostBatch
from siddhi_tpu_torch.core.table.in_memory_table import InMemoryTable, TableConditionResolver
from siddhi_tpu_torch.ops.expressions import CompileError, compile_condition, compile_expr
from siddhi_tpu_torch.query_api.definitions import Attribute, StreamDefinition
from siddhi_tpu_torch.query_api.execution import (
    DeleteStream,
    InsertIntoStream,
    UpdateOrInsertStream,
    UpdateStream,
)


def _out_def(query_name: str, output_attrs) -> StreamDefinition:
    return StreamDefinition(
        id=f"{query_name}#out",
        attributes=[Attribute(n, t) for n, t in output_attrs],
    )


class InsertIntoTableCallback:
    """Output rows appended to the table (positional schema match)."""

    def __init__(self, table: InMemoryTable, output_attrs, dictionary):
        if len(output_attrs) != len(table.definition.attributes):
            raise CompileError(
                f"insert into table '{table.definition.id}': query outputs "
                f"{len(output_attrs)} attributes, table has "
                f"{len(table.definition.attributes)}"
            )
        for (name, t), attr in zip(output_attrs, table.definition.attributes):
            if t != attr.type:
                # the inferred output definition must be equivalent to the
                # table's (reference DuplicateDefinitionException when the
                # insert-into target is a defined table with other types)
                from siddhi_tpu_torch.compiler.errors import DuplicateDefinitionException

                raise DuplicateDefinitionException(
                    f"insert into table '{table.definition.id}': output "
                    f"attribute '{name}' is {t.value} but the table column "
                    f"'{attr.name}' is {attr.type.value}")
        self.table = table
        self.dictionary = dictionary

    def __call__(self, events: List[Event]):
        if not events:
            return
        # expired events act as regular rows here: the selector's
        # output-event-type filter already chose what reaches the table
        # (reference converts EXPIRED->CURRENT before the table op)
        rows = [Event(timestamp=e.timestamp, data=e.data) for e in events]
        batch = HostBatch.from_events(rows, self.table.definition, self.dictionary)
        self.table.insert(batch)


class _ConditionedTableCallback:
    def __init__(self, table: InMemoryTable, query_name: str, output_attrs,
                 on_condition, dictionary):
        self.table = table
        self.dictionary = dictionary
        self.out_def = _out_def(query_name, output_attrs)
        resolver = TableConditionResolver(table.definition, self.out_def, dictionary)
        self.resolver = resolver
        self.cond = compile_condition(on_condition, resolver) if on_condition is not None else None

    def _batch(self, events: List[Event]) -> Optional[HostBatch]:
        if not events:
            return None
        rows = [Event(timestamp=e.timestamp, data=e.data) for e in events]
        return HostBatch.from_events(rows, self.out_def, self.dictionary)


class DeleteTableCallback(_ConditionedTableCallback):
    def __call__(self, events: List[Event]):
        batch = self._batch(events)
        if batch is not None:
            self.table.delete(self.cond, batch)


def _compile_assignments(table, out_def, update_set, resolver):
    """[(table col, fn, type)] — explicit `set` clause, or all table
    attributes updated from same-named output attributes (reference
    UpdateTableCallback default)."""
    from siddhi_tpu_torch.query_api.expressions import Variable

    assignments: List[Tuple[str, Callable, object]] = []
    if update_set is not None:
        for sa in update_set.set_attributes:
            attr = table.definition.attribute(sa.table_variable.attribute_name)
            fn, t = compile_expr(sa.assignment, resolver)
            assignments.append((attr.name, fn, t))
    else:
        out_names = {a.name for a in out_def.attributes}
        for attr in table.definition.attributes:
            if attr.name in out_names:
                fn, t = compile_expr(Variable(attribute_name=attr.name), resolver)
                assignments.append((attr.name, fn, t))
        if not assignments:
            raise CompileError(
                f"update {table.definition.id}: no output attribute matches a "
                f"table attribute and no `set` clause given"
            )
    return assignments


class UpdateTableCallback(_ConditionedTableCallback):
    def __init__(self, table, query_name, output_attrs, on_condition, update_set,
                 dictionary):
        super().__init__(table, query_name, output_attrs, on_condition, dictionary)
        self.assignments = _compile_assignments(table, self.out_def, update_set,
                                                self.resolver)

    def __call__(self, events: List[Event]):
        batch = self._batch(events)
        if batch is not None:
            self.table.update(self.cond, self.assignments, batch)


class UpdateOrInsertTableCallback(UpdateTableCallback):
    def __init__(self, table, query_name, output_attrs, on_condition, update_set,
                 dictionary):
        super().__init__(table, query_name, output_attrs, on_condition, update_set,
                         dictionary)
        # unmatched events insert positionally, like `insert into`
        if len(output_attrs) == len(table.definition.attributes):
            self.insert_mapping = [
                (tattr.name, oname)
                for tattr, (oname, _t) in zip(table.definition.attributes,
                                              output_attrs)
            ]
        else:
            # the reference also accepts a PARTIAL output set when every
            # output attribute names a table column (UpdateOrInsert-
            # TableTestCase.java updateOrInsertTableTest5: `comp as symbol,
            # vol as volume` against a 3-attr table) — unmatched events
            # insert BY NAME with the absent columns null
            tnames = {a.name for a in table.definition.attributes}
            missing = [o for o, _t in output_attrs if o not in tnames]
            if missing:
                raise CompileError(
                    f"update or insert into '{table.definition.id}': query "
                    f"outputs {len(output_attrs)} attributes, table has "
                    f"{len(table.definition.attributes)}, and "
                    f"{missing} match no table attribute"
                )
            onames = {o for o, _t in output_attrs}
            self.insert_mapping = [
                (tattr.name, tattr.name if tattr.name in onames else None)
                for tattr in table.definition.attributes
            ]

    def __call__(self, events: List[Event]):
        batch = self._batch(events)
        if batch is not None:
            self.table.update_or_insert(self.cond, self.assignments, batch,
                                        insert_mapping=self.insert_mapping)


def create_table_callback(out, table, query_name, output_attrs, dictionary):
    """Dispatch an output action targeting a table (reference
    ``OutputParser.constructOutputCallback``)."""
    if isinstance(out, InsertIntoStream):
        return InsertIntoTableCallback(table, output_attrs, dictionary)
    if isinstance(out, DeleteStream):
        return DeleteTableCallback(table, query_name, output_attrs, out.on_delete,
                                   dictionary)
    if isinstance(out, UpdateStream):
        return UpdateTableCallback(table, query_name, output_attrs, out.on_update,
                                   out.update_set, dictionary)
    if isinstance(out, UpdateOrInsertStream):
        return UpdateOrInsertTableCallback(table, query_name, output_attrs,
                                           out.on_update, out.update_set, dictionary)
    raise CompileError(f"unsupported table output action {type(out).__name__}")
