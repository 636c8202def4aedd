"""Recursive-descent SiddhiQL parser: tokens -> query-api IR.

Covers the surface of the reference grammar
(``siddhi-query-compiler/.../SiddhiQL.g4``: ``siddhi_app``:34,
``definition_aggregation``:118, ``partition``:155, ``query``:180,
``pattern_stream``:200, ``sequence_stream``:291, ``store_query``:71) and the
folding logic of ``internal/SiddhiQLBaseVisitorImpl.java``, as a hand-written
parser.
"""

from __future__ import annotations

from typing import List, Optional

from siddhi_tpu_torch.compiler.errors import SiddhiParserException
from siddhi_tpu_torch.compiler.tokenizer import Token, is_time_unit, time_unit_ms, tokenize
from siddhi_tpu_torch.query_api.annotations import Annotation
from siddhi_tpu_torch.query_api.definitions import (
    AggregationDefinition,
    Attribute,
    AttrType,
    Duration,
    FunctionDefinition,
    StreamDefinition,
    TableDefinition,
    TimePeriod,
    TriggerDefinition,
    WindowDefinition,
)
from siddhi_tpu_torch.query_api.execution import (
    AbsentStreamStateElement,
    CountStateElement,
    DeleteStream,
    EventOutputRate,
    EventTrigger,
    EveryStateElement,
    Filter,
    InputStore,
    InsertIntoStream,
    JoinInputStream,
    JoinType,
    LogicalStateElement,
    NextStateElement,
    OnDemandQuery,
    OrderByAttribute,
    OutputAttribute,
    Partition,
    Query,
    RangeCondition,
    RangePartitionType,
    ReturnStream,
    Selector,
    SetAttribute,
    SingleInputStream,
    SnapshotOutputRate,
    StateElement,
    StateInputStream,
    StateInputStreamType,
    StreamFunction,
    StreamStateElement,
    TimeOutputRate,
    UpdateOrInsertStream,
    UpdateSet,
    UpdateStream,
    ValuePartitionType,
    Window,
)
from siddhi_tpu_torch.query_api.expressions import (
    Add,
    And,
    AttributeFunction,
    Compare,
    Constant,
    Divide,
    Expression,
    InOp,
    IsNull,
    Mod,
    Multiply,
    Not,
    Or,
    Subtract,
    TimeConstant,
    Variable,
)
from siddhi_tpu_torch.query_api.siddhi_app import SiddhiApp

_TYPE_MAP = {
    "string": AttrType.STRING,
    "int": AttrType.INT,
    "long": AttrType.LONG,
    "float": AttrType.FLOAT,
    "double": AttrType.DOUBLE,
    "bool": AttrType.BOOL,
    "object": AttrType.OBJECT,
}

# Keywords that terminate a from-clause at bracket depth 0.
_FROM_END = {"select", "insert", "delete", "update", "return", "output", "group", "having", "order", "limit", "offset"}


class Parser:
    def __init__(self, tokens: List[Token]):
        self.tokens = tokens
        self.pos = 0

    # ------------------------------------------------------------- helpers

    def peek(self, offset: int = 0) -> Token:
        i = min(self.pos + offset, len(self.tokens) - 1)
        return self.tokens[i]

    def next(self) -> Token:
        t = self.tokens[self.pos]
        if t.kind != "eof":
            self.pos += 1
        return t

    def error(self, message: str, tok: Optional[Token] = None):
        t = tok or self.peek()
        raise SiddhiParserException(message, t.line, t.col, t.text)

    def expect_op(self, op: str) -> Token:
        t = self.peek()
        if not t.is_op(op):
            self.error(f"expected '{op}'")
        return self.next()

    def expect_kw(self, *kws: str) -> Token:
        t = self.peek()
        if not t.is_kw(*kws):
            self.error(f"expected {'/'.join(kws)}")
        return self.next()

    def accept_op(self, op: str) -> bool:
        if self.peek().is_op(op):
            self.next()
            return True
        return False

    def accept_kw(self, *kws: str) -> bool:
        if self.peek().is_kw(*kws):
            self.next()
            return True
        return False

    def name(self) -> str:
        """An identifier; keywords are allowed as names (e.g. `min(price)`)."""
        t = self.peek()
        if t.kind not in ("id", "keyword"):
            self.error("expected a name")
        return self.next().text

    def at_time_constant(self) -> bool:
        return self.peek().kind in ("int", "long") and (
            self.peek(1).kind == "keyword" and is_time_unit(self.peek(1).text)
        )

    def parse_time_constant(self) -> TimeConstant:
        total = 0
        while self.at_time_constant():
            value = self.next().value
            unit = self.next().text
            total += value * time_unit_ms(unit)
        return TimeConstant(total)

    # --------------------------------------------------------- annotations

    def parse_annotations(self) -> List[Annotation]:
        out = []
        while self.peek().is_op("@"):
            out.append(self.parse_annotation())
        return out

    def parse_annotation(self) -> Annotation:
        self.expect_op("@")
        name = self.name()
        if self.accept_op(":"):
            name = f"{name}:{self.name()}"
        ann = Annotation(name=name)
        if self.accept_op("("):
            if not self.peek().is_op(")"):
                while True:
                    if self.peek().is_op("@"):
                        ann.annotations.append(self.parse_annotation())
                    else:
                        key = None
                        # key may be dotted: buffer.size='64'
                        if self.peek().kind in ("id", "keyword") and (
                            self.peek(1).is_op("=") or self.peek(1).is_op(".")
                        ):
                            parts = [self.name()]
                            while self.accept_op("."):
                                parts.append(self.name())
                            key = ".".join(parts)
                            self.expect_op("=")
                        t = self.peek()
                        if t.kind in ("string", "int", "long", "float", "double"):
                            self.next()
                            ann.elements.append((key, str(t.value)))
                        elif t.is_kw("true", "false"):
                            self.next()
                            ann.elements.append((key, t.text.lower()))
                        else:
                            self.error("expected annotation element value")
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
        return ann

    # ----------------------------------------------------------- top level

    def parse_siddhi_app(self) -> SiddhiApp:
        app = SiddhiApp()
        while True:
            t = self.peek()
            if t.kind == "eof":
                break
            if t.is_op(";"):
                self.next()
                continue
            annotations = self.parse_annotations()
            # `@app:*` annotations are app-level regardless of position
            # (reference SiddhiAppParser.java:91-212); the rest bind to the
            # immediately following definition/query/partition.
            element_annotations = []
            for a in annotations:
                if a.name.lower().startswith("app:"):
                    app.annotations.append(a)
                else:
                    element_annotations.append(a)
            t = self.peek()
            if t.is_kw("define"):
                self.parse_definition(app, element_annotations)
            elif t.is_kw("partition"):
                app.execution_elements.append(self.parse_partition(element_annotations))
            elif t.is_kw("from"):
                app.execution_elements.append(self.parse_query(element_annotations))
            elif t.kind == "eof" or t.is_op(";"):
                app.annotations.extend(element_annotations)
            else:
                self.error("expected 'define', 'from', 'partition' or annotation")
        return app

    def parse_definition(self, app: SiddhiApp, element_annotations: List[Annotation]):
        self.expect_kw("define")
        t = self.peek()
        if t.is_kw("stream"):
            self.next()
            d = StreamDefinition(id=self.name(), annotations=element_annotations)
            d.attributes = self.parse_attribute_list()
            app.define_stream(d)
        elif t.is_kw("table"):
            self.next()
            d = TableDefinition(id=self.name(), annotations=element_annotations)
            d.attributes = self.parse_attribute_list()
            app.define_table(d)
        elif t.is_kw("window"):
            self.next()
            d = WindowDefinition(id=self.name(), annotations=element_annotations)
            d.attributes = self.parse_attribute_list()
            d.window = self.parse_window_handler_bare()
            if self.accept_kw("output"):
                ev = self.expect_kw("current", "expired", "all").text.lower()
                self.expect_kw("events")
                d.output_event_type = ev
            app.define_window(d)
        elif t.is_kw("trigger"):
            self.next()
            d = TriggerDefinition(id=self.name(), annotations=element_annotations)
            self.expect_kw("at")
            if self.accept_kw("every"):
                d.at_every = self.parse_time_constant().value
            elif self.peek().kind == "string":
                s = self.next().value
                if s.lower() == "start":
                    d.at_start = True
                else:
                    d.cron = s
            else:
                self.error("expected 'every <time>' or a quoted cron/'start'")
            app.define_trigger(d)
        elif t.is_kw("function"):
            self.next()
            d = FunctionDefinition(id=self.name())
            self.expect_op("[")
            d.language = self.name()
            self.expect_op("]")
            self.expect_kw("return")
            type_tok = self.next()
            d.return_type = _TYPE_MAP[type_tok.text.lower()]
            body = self.peek()
            if body.kind != "script":
                self.error("expected function body { ... }")
            d.body = self.next().value
            app.function_definitions[d.id] = d
        elif t.is_kw("aggregation"):
            self.next()
            d = AggregationDefinition(id=self.name(), annotations=element_annotations)
            self.expect_kw("from")
            d.input_stream = self.parse_single_input_stream()
            d.selector = self.parse_selector_clauses()
            self.expect_kw("aggregate")
            if self.accept_kw("by"):
                d.aggregate_attribute = self.parse_variable()
            self.expect_kw("every")
            d.time_period = self.parse_time_period()
            app.define_aggregation(d)
        else:
            self.error("expected stream/table/window/trigger/function/aggregation")
        self.accept_op(";")

    def parse_attribute_list(self) -> List[Attribute]:
        self.expect_op("(")
        attrs = []
        while True:
            attr_name = self.name()
            type_tok = self.next()
            if type_tok.text.lower() not in _TYPE_MAP:
                self.error(f"unknown type '{type_tok.text}'", type_tok)
            attrs.append(Attribute(attr_name, _TYPE_MAP[type_tok.text.lower()]))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return attrs

    def parse_window_handler_bare(self) -> Window:
        """`time(5 sec)` / `ns:name(args)` in a window definition (no `#window.`)."""
        ns = ""
        nm = self.name()
        if self.accept_op(":"):
            ns, nm = nm, self.name()
        params = self.parse_call_params()
        return Window(namespace=ns, name=nm, parameters=params)

    def parse_time_period(self) -> TimePeriod:
        durations = [self.parse_duration()]
        if self.peek().is_op("."):
            # range: sec ... year
            self.expect_op(".")
            self.expect_op(".")
            self.expect_op(".")
            durations.append(self.parse_duration())
            return TimePeriod(operator="range", durations=durations)
        while self.accept_op(","):
            durations.append(self.parse_duration())
        op = "interval" if len(durations) > 1 else "range"
        return TimePeriod(operator=op, durations=durations)

    def parse_duration(self) -> Duration:
        t = self.next()
        key = t.text.lower()
        mapping = {
            "sec": Duration.SECONDS, "second": Duration.SECONDS, "seconds": Duration.SECONDS,
            "min": Duration.MINUTES, "minute": Duration.MINUTES, "minutes": Duration.MINUTES,
            "hour": Duration.HOURS, "hours": Duration.HOURS,
            "day": Duration.DAYS, "days": Duration.DAYS,
            "month": Duration.MONTHS, "months": Duration.MONTHS,
            "year": Duration.YEARS, "years": Duration.YEARS,
        }
        if key not in mapping:
            self.error(f"unknown duration '{t.text}'", t)
        return mapping[key]

    # ------------------------------------------------------------ partition

    def parse_partition(self, annotations: List[Annotation]) -> Partition:
        self.expect_kw("partition")
        self.expect_kw("with")
        self.expect_op("(")
        p = Partition(annotations=annotations)
        while True:
            p.partition_types.append(self.parse_partition_type())
            if not self.accept_op(","):
                break
        self.expect_op(")")
        self.expect_kw("begin")
        while not self.peek().is_kw("end"):
            q_annotations = self.parse_annotations()
            p.queries.append(self.parse_query(q_annotations))
            self.accept_op(";")
        self.expect_kw("end")
        self.accept_op(";")
        return p

    def parse_partition_type(self):
        # range form:  cond as 'label' or cond as 'label' ... of Stream
        # value form:  expr of Stream
        start = self.pos
        expr = self.parse_expression()
        if self.peek().is_kw("as"):
            self.pos = start
            conditions = []
            while True:
                cond = self.parse_expression()
                self.expect_kw("as")
                label_tok = self.peek()
                if label_tok.kind != "string":
                    self.error("expected partition range label string")
                self.next()
                conditions.append(RangeCondition(partition_key=label_tok.value, condition=cond))
                if not self.accept_kw("or"):
                    break
            self.expect_kw("of")
            stream_id = self.name()
            return RangePartitionType(stream_id=stream_id, conditions=conditions)
        self.expect_kw("of")
        stream_id = self.name()
        return ValuePartitionType(stream_id=stream_id, expression=expr)

    # -------------------------------------------------------------- queries

    def parse_query(self, annotations: List[Annotation]) -> Query:
        q = Query(annotations=annotations)
        self.expect_kw("from")
        q.input_stream = self.parse_input_stream()
        q.selector = self.parse_selector_clauses()
        q.output_rate = self.parse_output_rate()
        q.output_stream = self.parse_output_action()
        self.accept_op(";")
        return q

    # .............................................. from-clause classifier

    def _scan_from_clause_kind(self) -> str:
        """Look ahead (no consumption) to classify single/join/pattern."""
        depth = 0
        i = self.pos
        saw_arrow = saw_comma = saw_join = saw_assign = saw_every = saw_not = False
        first = True
        while i < len(self.tokens):
            t = self.tokens[i]
            if t.kind == "eof":
                break
            if t.is_op("(", "["):
                depth += 1
            elif t.is_op(")", "]"):
                depth -= 1
            elif depth == 0:
                if t.kind == "keyword" and t.text.lower() in _FROM_END:
                    break
                if t.is_op(";"):
                    break
                if t.is_op("->"):
                    saw_arrow = True
                if t.is_op(","):
                    saw_comma = True
                if t.is_kw("join"):
                    saw_join = True
                if t.is_op("=") and not (i + 1 < len(self.tokens) and self.tokens[i + 1].is_op("=")):
                    saw_assign = True
                if first and t.is_kw("every"):
                    saw_every = True
                if first and t.is_kw("not"):
                    saw_not = True
            first = False
            i += 1
        if saw_arrow:
            return "pattern"
        if saw_comma and not saw_join:
            return "sequence"
        if saw_every or saw_not or (saw_assign and not saw_join):
            return "pattern"
        if saw_join:
            return "join"
        return "single"

    def parse_input_stream(self):
        kind = self._scan_from_clause_kind()
        if kind == "single":
            return self.parse_single_input_stream()
        if kind == "join":
            return self.parse_join_input_stream()
        return self.parse_state_input_stream(
            StateInputStreamType.PATTERN if kind == "pattern" else StateInputStreamType.SEQUENCE
        )

    # ....................................................... single stream

    def parse_single_input_stream(self) -> SingleInputStream:
        is_inner = self.accept_op("#")
        is_fault = False if is_inner else self.accept_op("!")
        stream_id = self.name()
        s = SingleInputStream(stream_id=stream_id, is_inner_stream=is_inner, is_fault_stream=is_fault)
        s.handlers = self.parse_stream_handlers()
        return s

    def parse_stream_handlers(self) -> List:
        handlers = []
        while True:
            t = self.peek()
            if t.is_op("["):
                self.next()
                handlers.append(Filter(self.parse_expression()))
                self.expect_op("]")
            elif t.is_op("#"):
                self.next()
                if self.peek().is_op("["):
                    # '#[expr]' filter-handler shorthand (SiddhiQL grammar
                    # StreamHandler: '#'? '[' expression ']')
                    self.next()
                    handlers.append(Filter(self.parse_expression()))
                    self.expect_op("]")
                    continue
                nm = self.name()
                if nm.lower() == "window" and self.accept_op("."):
                    wname = self.name()
                    params = self.parse_call_params()
                    handlers.append(Window(namespace="", name=wname, parameters=params))
                else:
                    ns = ""
                    if self.accept_op(":"):
                        ns, nm = nm, self.name()
                    params = self.parse_call_params()
                    handlers.append(StreamFunction(namespace=ns, name=nm, parameters=params))
            else:
                break
        return handlers

    def parse_call_params(self) -> List[Expression]:
        params: List[Expression] = []
        self.expect_op("(")
        if not self.peek().is_op(")"):
            while True:
                params.append(self.parse_expression())
                if not self.accept_op(","):
                    break
        self.expect_op(")")
        return params

    # ............................................................... join

    def parse_join_input_stream(self) -> JoinInputStream:
        left, left_uni = self.parse_join_side()
        join_type = self.parse_join_type()
        right, right_uni = self.parse_join_side()
        on = None
        within = None
        per = None
        if self.accept_kw("on"):
            on = self.parse_expression()
        if self.accept_kw("within"):
            within = self.parse_time_constant() if self.at_time_constant() else self.parse_expression()
            if self.accept_op(","):
                end = (self.parse_time_constant() if self.at_time_constant()
                       else self.parse_expression())
                within = (within, end)   # `within start, end` (agg joins)
        if self.accept_kw("per"):
            per = self.parse_expression()
        trigger = EventTrigger.ALL
        if left_uni and right_uni:
            self.error("both join sides cannot be unidirectional")
        elif left_uni:
            trigger = EventTrigger.LEFT
        elif right_uni:
            trigger = EventTrigger.RIGHT
        return JoinInputStream(left=left, right=right, type=join_type, on_compare=on,
                               trigger=trigger, within=within, per=per)

    def parse_join_side(self):
        s = self.parse_single_input_stream()
        if self.accept_kw("as"):
            s.stream_reference_id = self.name()
        unidirectional = self.accept_kw("unidirectional")
        if s.stream_reference_id is None and self.accept_kw("as"):
            s.stream_reference_id = self.name()
        return s, unidirectional

    def parse_join_type(self) -> JoinType:
        if self.accept_kw("left"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return JoinType.LEFT_OUTER_JOIN
        if self.accept_kw("right"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return JoinType.RIGHT_OUTER_JOIN
        if self.accept_kw("full"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return JoinType.FULL_OUTER_JOIN
        if self.accept_kw("inner"):
            self.expect_kw("join")
            return JoinType.INNER_JOIN
        self.expect_kw("join")
        return JoinType.JOIN

    # .................................................. pattern / sequence

    def parse_state_input_stream(self, state_type: StateInputStreamType) -> StateInputStream:
        sep = "->" if state_type == StateInputStreamType.PATTERN else ","
        element = self.parse_state_chain(sep, state_type)
        within = None
        if self.accept_kw("within"):
            within = self.parse_time_constant().value
        return StateInputStream(state_type=state_type, state_element=element, within=within)

    def parse_state_chain(self, sep: str, state_type, depth: int = 0) -> StateElement:
        left = self.parse_state_unit(sep, state_type, depth)
        while (sep == "->" and self.accept_op("->")) or (sep == "," and self.accept_op(",")):
            right = self.parse_state_unit(sep, state_type, depth)
            left = NextStateElement(state=left, next=right)
        return left

    def _accept_scoped_within(self, depth: int):
        """A trailing top-level `within` belongs to the whole pattern
        (SiddhiQL.g4 pattern_stream: ... within_time?) — bind it to the
        preceding element only when more chain follows or we are inside
        parentheses (the scoped-within extension)."""
        mark = self.pos
        if not self.accept_kw("within"):
            return None
        w = self.parse_time_constant().value
        if depth > 0 or self.peek().is_op("->") or self.peek().is_op(","):
            return w
        self.pos = mark
        return None

    def parse_state_unit(self, sep: str, state_type, depth: int = 0) -> StateElement:
        if self.accept_kw("every"):
            if self.accept_op("("):
                inner = self.parse_state_chain(sep, state_type, depth + 1)
                self.expect_op(")")
                el: StateElement = EveryStateElement(state=inner)
            else:
                el = EveryStateElement(state=self.parse_state_source(sep, state_type))
            w = self._accept_scoped_within(depth)
            if w is not None:
                el.within = w
            return el
        if self.accept_op("("):
            inner = self.parse_state_chain(sep, state_type, depth + 1)
            self.expect_op(")")
            # `(...) within t` is always the scoped-within extension: the
            # parentheses make the scope explicit
            if self.accept_kw("within"):
                inner.within = self.parse_time_constant().value
            return inner
        return self.parse_state_source(sep, state_type)

    def parse_state_source(self, sep: str, state_type) -> StateElement:
        """One pattern source: logical / count / absent / plain stream.
        Absent sides (``not X [for t]``) may pair with present or absent
        sides through and/or (reference SiddhiQL.g4 absent_pattern_source /
        logical_absent_stateful_source)."""
        first = self.parse_maybe_absent_stream()
        t = self.peek()
        if t.is_kw("and", "or"):
            op = self.next().text.lower()
            second = self.parse_maybe_absent_stream()
            return LogicalStateElement(stream1=first, type=op, stream2=second)
        if isinstance(first, AbsentStreamStateElement):
            if first.waiting_time is None:
                self.error(
                    "absent pattern requires 'for <time>' or an and/or pairing")
            return first
        # count / regex quantifiers ('<:' is the tokenizer-fused max-only
        # form, e.g. `<:5>`)
        if t.is_op("<") or t.is_op("<:"):
            return self.parse_count_suffix(first)
        if t.is_op("+"):
            self.next()
            return CountStateElement(state=first, min_count=1, max_count=CountStateElement.ANY)
        if t.is_op("*"):
            self.next()
            return CountStateElement(state=first, min_count=0, max_count=CountStateElement.ANY)
        if t.is_op("?"):
            self.next()
            return CountStateElement(state=first, min_count=0, max_count=1)
        return first

    def parse_count_suffix(self, inner: StreamStateElement) -> CountStateElement:
        # forms: <2> | <2:5> | <2:> | <:5>   (tokenizer may fuse '<:' and ':>')
        el = CountStateElement(state=inner)
        if self.accept_op("<:"):
            el.min_count = CountStateElement.ANY
            el.max_count = self.next().value
            self.expect_op(">")
            return el
        self.expect_op("<")
        if self.accept_op(":"):
            # whitespace-separated max-only form `< :5>` (the ANTLR
            # grammar is whitespace-insensitive between '<' and ':')
            el.min_count = CountStateElement.ANY
            el.max_count = self.next().value
            self.expect_op(">")
            return el
        el.min_count = self.next().value
        if self.accept_op(":>"):
            # ':>' fused by the tokenizer — the closing '>' is already consumed
            el.max_count = CountStateElement.ANY
            return el
        if self.accept_op(":"):
            if self.peek().kind in ("int", "long"):
                el.max_count = self.next().value
            else:
                el.max_count = CountStateElement.ANY
        else:
            el.max_count = el.min_count
        self.expect_op(">")
        return el

    def parse_standard_state_stream(self) -> StreamStateElement:
        ref = None
        if (
            self.peek().kind in ("id", "keyword")
            and self.peek(1).is_op("=")
            and not self.peek(2).is_op("=")
        ):
            ref = self.name()
            self.expect_op("=")
        stream = self.parse_single_input_stream()
        stream.stream_reference_id = ref
        el = StreamStateElement(stream=stream)
        return el

    def parse_maybe_absent_stream(self) -> StreamStateElement:
        """Either ``not X [for t]`` or a plain (possibly captured) stream."""
        if self.accept_kw("not"):
            absent = self.parse_absent_stream()
            if self.accept_kw("for"):
                absent.waiting_time = self.parse_time_constant().value
            return absent
        return self.parse_standard_state_stream()

    def parse_absent_stream(self) -> AbsentStreamStateElement:
        stream = self.parse_single_input_stream()
        return AbsentStreamStateElement(stream=stream)

    # ....................................................... select clause

    def parse_selector_clauses(self) -> Selector:
        sel = Selector()
        if self.accept_kw("select"):
            if self.accept_op("*"):
                sel.select_all = True
            else:
                while True:
                    expr = self.parse_expression()
                    rename = None
                    if self.accept_kw("as"):
                        rename = self.name()
                    sel.selection_list.append(OutputAttribute(rename=rename, expression=expr))
                    if not self.accept_op(","):
                        break
        else:
            sel.select_all = True
        if self.accept_kw("group"):
            self.expect_kw("by")
            while True:
                sel.group_by_list.append(self.parse_variable())
                if not self.accept_op(","):
                    break
        if self.accept_kw("having"):
            sel.having = self.parse_expression()
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                var = self.parse_variable()
                order = "asc"
                if self.accept_kw("asc"):
                    order = "asc"
                elif self.accept_kw("desc"):
                    order = "desc"
                sel.order_by_list.append(OrderByAttribute(variable=var, order=order))
                if not self.accept_op(","):
                    break
        if self.accept_kw("limit"):
            sel.limit = self.next().value
        if self.accept_kw("offset"):
            sel.offset = self.next().value
        return sel

    def parse_output_rate(self):
        if not self.peek().is_kw("output"):
            return None
        # careful: `output` also starts output actions in store queries — but
        # in queries the action keywords are insert/delete/update/return.
        self.next()
        if self.accept_kw("snapshot"):
            self.expect_kw("every")
            return SnapshotOutputRate(value=self.parse_time_constant().value)
        rate_type = "all"
        if self.accept_kw("all"):
            rate_type = "all"
        elif self.accept_kw("first"):
            rate_type = "first"
        elif self.accept_kw("last"):
            rate_type = "last"
        self.expect_kw("every")
        if self.at_time_constant():
            return TimeOutputRate(value=self.parse_time_constant().value, type=rate_type)
        value = self.next().value
        self.expect_kw("events")
        return EventOutputRate(value=value, type=rate_type)

    def parse_output_event_type(self) -> Optional[str]:
        for kw in ("current", "expired", "all"):
            if self.peek().is_kw(kw):
                self.next()
                self.expect_kw("events")
                return kw
        if self.peek().is_kw("events"):
            # bare `insert events into` == current events (SiddhiQL.g4
            # output_event_type: the type qualifier is optional)
            self.next()
            return "current"
        return None

    def parse_output_action(self):
        if self.accept_kw("insert"):
            # `insert overwrite` is legacy; not supported
            ev = self.parse_output_event_type() or "current"
            if self.accept_kw("into"):
                is_inner = self.accept_op("#")
                is_fault = False if is_inner else self.accept_op("!")
                target = self.name()
                return InsertIntoStream(target_id=target, output_event_type=ev,
                                        is_inner_stream=is_inner, is_fault_stream=is_fault)
            self.error("expected 'into'")
        if self.accept_kw("delete"):
            target = self.name()
            ev = self.parse_output_event_type_for() or "current"
            self.expect_kw("on")
            cond = self.parse_expression()
            return DeleteStream(target_id=target, output_event_type=ev, on_delete=cond)
        if self.accept_kw("update"):
            if self.accept_kw("or"):
                self.expect_kw("insert")
                self.expect_kw("into")
                target = self.name()
                update_set = self.parse_update_set()
                self.expect_kw("on")
                cond = self.parse_expression()
                return UpdateOrInsertStream(target_id=target, on_update=cond, update_set=update_set)
            target = self.name()
            ev = self.parse_output_event_type_for() or "current"
            update_set = self.parse_update_set()
            self.expect_kw("on")
            cond = self.parse_expression()
            return UpdateStream(target_id=target, output_event_type=ev, on_update=cond,
                                update_set=update_set)
        if self.accept_kw("return"):
            return ReturnStream()
        self.error("expected insert/delete/update/return output action")

    def parse_output_event_type_for(self) -> Optional[str]:
        if self.accept_kw("for"):
            for kw in ("current", "expired", "all"):
                if self.peek().is_kw(kw):
                    self.next()
                    self.expect_kw("events")
                    return kw
            self.error("expected current/expired/all events")
        return None

    def parse_update_set(self) -> Optional[UpdateSet]:
        if not self.accept_kw("set"):
            return None
        us = UpdateSet()
        while True:
            table_var = self.parse_variable()
            self.expect_op("=")
            value = self.parse_expression()
            us.set_attributes.append(SetAttribute(table_variable=table_var, assignment=value))
            if not self.accept_op(","):
                break
        return us

    # --------------------------------------------------- on-demand queries

    @staticmethod
    def _mutation_type(out, default: str) -> str:
        if isinstance(out, DeleteStream):
            return "delete"
        if isinstance(out, UpdateOrInsertStream):
            return "update_or_insert"
        if isinstance(out, UpdateStream):
            return "update"
        return default

    def parse_on_demand_query(self) -> OnDemandQuery:
        q = OnDemandQuery()
        t = self.peek()
        if t.is_kw("delete") or (t.is_kw("update") and not self.peek(1).is_kw("or")):
            # `delete Table on <cond>` / `update Table set ... on <cond>`
            # (reference StoreQuery mutation forms)
            q.output_stream = self.parse_output_action()
            q.type = ("delete" if isinstance(q.output_stream, DeleteStream)
                      else "update")
            return q
        if t.is_kw("update"):  # `update or insert into Table set ... on ...`
            q.output_stream = self.parse_output_action()
            q.type = "update_or_insert"
            return q
        if self.accept_kw("from"):
            store = InputStore(store_id=self.name())
            if self.accept_kw("as"):
                store.store_reference_id = self.name()
            if self.accept_kw("on"):
                store.on_condition = self.parse_expression()
            if self.accept_kw("within"):
                first = (self.parse_time_constant()
                         if self.at_time_constant() else self.parse_expression())
                if self.accept_op(","):
                    second = (self.parse_time_constant()
                              if self.at_time_constant() else self.parse_expression())
                    store.within = (first, second)  # start, end
                else:
                    store.within = first
                if self.accept_kw("per"):
                    store.per = self.parse_expression()
            q.input_store = store
            q.selector = self.parse_selector_clauses()
            t = self.peek()
            if t.is_kw("insert", "update", "delete", "return") :
                q.output_stream = self.parse_output_action()
                q.type = self._mutation_type(q.output_stream, "find")
            else:
                q.output_stream = ReturnStream()
                q.type = "find"
            return q
        if self.accept_kw("select"):
            # `select ... {insert|update|update or insert|delete} ...` —
            # the projection becomes the mutation's pseudo trigger event
            self.pos -= 1
            q.selector = self.parse_selector_clauses()
            q.output_stream = self.parse_output_action()
            q.type = self._mutation_type(q.output_stream, "insert")
            return q
        self.error("expected on-demand query")

    # ---------------------------------------------------------- expressions

    def parse_expression(self) -> Expression:
        return self.parse_or()

    def parse_or(self) -> Expression:
        # `or(...)`/`and(...)` as *aggregator calls* only occur at primary
        # position, where parse_primary -> parse_name_expression handles them;
        # here 'or' is always the infix boolean.
        left = self.parse_and()
        while self.peek().is_kw("or"):
            self.next()
            left = Or(left, self.parse_and())
        return left

    def parse_and(self) -> Expression:
        left = self.parse_not()
        while self.peek().is_kw("and"):
            self.next()
            left = And(left, self.parse_not())
        return left

    def parse_not(self) -> Expression:
        if self.accept_kw("not"):
            return Not(self.parse_not())
        return self.parse_compare()

    def parse_compare(self) -> Expression:
        left = self.parse_additive()
        while True:
            t = self.peek()
            if t.is_op("<", "<=", ">", ">=", "==", "!="):
                op = self.next().text
                right = self.parse_additive()
                left = Compare(left, op, right)
            elif t.is_kw("in"):
                self.next()
                left = InOp(expression=left, source_id=self.name())
            elif t.is_kw("is") and self.peek(1).is_kw("null"):
                self.next()
                self.next()
                if isinstance(left, Variable) and left.stream_id is None and left.stream_index is None:
                    # could be a stream-state null check (`e1 is null`); the
                    # runtime parser resolves attr-vs-stream by name.
                    left = IsNull(expression=left)
                else:
                    left = IsNull(expression=left)
            else:
                return left

    def parse_additive(self) -> Expression:
        left = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.is_op("+"):
                self.next()
                left = Add(left, self.parse_multiplicative())
            elif t.is_op("-"):
                self.next()
                left = Subtract(left, self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self) -> Expression:
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.is_op("*"):
                self.next()
                left = Multiply(left, self.parse_unary())
            elif t.is_op("/"):
                self.next()
                left = Divide(left, self.parse_unary())
            elif t.is_op("%"):
                self.next()
                left = Mod(left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> Expression:
        if self.peek().is_op("-"):
            self.next()
            inner = self.parse_unary()
            if isinstance(inner, Constant):
                return Constant(-inner.value, inner.type)
            return Subtract(Constant(0, AttrType.INT), inner)
        return self.parse_primary()

    def parse_primary(self) -> Expression:
        t = self.peek()
        if t.is_op("("):
            self.next()
            e = self.parse_expression()
            self.expect_op(")")
            return e
        if t.kind == "int":
            self.next()
            if self.peek().kind == "keyword" and is_time_unit(self.peek().text):
                self.pos -= 1
                return self.parse_time_constant()
            return Constant(t.value, AttrType.INT)
        if t.kind == "long":
            self.next()
            if self.peek().kind == "keyword" and is_time_unit(self.peek().text):
                self.pos -= 1
                return self.parse_time_constant()
            return Constant(t.value, AttrType.LONG)
        if t.kind == "float":
            self.next()
            return Constant(t.value, AttrType.FLOAT)
        if t.kind == "double":
            self.next()
            return Constant(t.value, AttrType.DOUBLE)
        if t.kind == "string":
            self.next()
            return Constant(t.value, AttrType.STRING)
        if t.is_kw("true"):
            self.next()
            return Constant(True, AttrType.BOOL)
        if t.is_kw("false"):
            self.next()
            return Constant(False, AttrType.BOOL)
        if t.kind in ("id", "keyword"):
            return self.parse_name_expression()
        if t.is_op("#"):
            # inner-stream qualified variable: '#Stream.attr' inside a
            # partition (SiddhiQL.g4 stream_id: '#'? name)
            self.next()
            e = self.parse_name_expression()
            if not isinstance(e, Variable) or e.stream_id is None:
                self.error("expected '#stream.attribute' reference", t)
            return Variable(attribute_name=e.attribute_name,
                            stream_id="#" + e.stream_id,
                            stream_index=e.stream_index)
        self.error("expected expression")

    def parse_name_expression(self) -> Expression:
        """function call | namespaced function | variable (possibly dotted)."""
        nm = self.name()
        # namespaced function ns:fn(...)
        if self.peek().is_op(":") and self.peek(2).is_op("("):
            self.next()
            fn = self.name()
            params = self.parse_call_params()
            return AttributeFunction(namespace=nm, name=fn, parameters=params)
        if self.peek().is_op("("):
            params = self.parse_call_params()
            return AttributeFunction(namespace="", name=nm, parameters=params)
        # variable forms: attr | stream.attr | ref[idx].attr
        stream_id = None
        stream_index = None
        attr = nm
        if self.peek().is_op("["):
            self.next()
            idx_tok = self.next()
            if idx_tok.is_kw("last"):
                stream_index = "last"
                if self.peek().is_op("-"):
                    self.next()
                    offset = self.next().value
                    stream_index = ("last", -offset)
            elif idx_tok.kind == "int":
                stream_index = idx_tok.value
            else:
                self.error("expected event index", idx_tok)
            self.expect_op("]")
            stream_id = nm
            if self.peek().is_op("."):
                self.next()
                attr = self.name()
            else:
                # bare indexed event ref (`e2[last-1] is null` — reference
                # SiddhiQL nullCheck over a StateEvent position)
                attr = None
        elif self.peek().is_op("."):
            self.next()
            stream_id = nm
            attr = self.name()
        return Variable(attribute_name=attr, stream_id=stream_id, stream_index=stream_index)

    def parse_variable(self) -> Variable:
        e = self.parse_name_expression()
        if not isinstance(e, Variable):
            self.error("expected attribute reference")
        return e
