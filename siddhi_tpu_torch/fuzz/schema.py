"""Typed case specs: streams, queries, events — the fuzzer's AST.

Counterpart of ``siddhi_tpu/fuzz/schema.py``, a copy: a case renders the
same SiddhiQL text in both packages, byte for byte, and its JSON is the
reference's, so one fixture loader reads both packages' fixtures.

Everything downstream of the generator — the differential runner, the
shrinker, the on-disk fixture format — operates on these specs, never
on raw SiddhiQL text: the shrinker drops a clause by clearing a FIELD
and re-rendering, so every reduction step is well-formed by
construction (the "Stream Types" discipline: a spec that renders is a
spec that type-checked when it was built).

A :class:`CaseSpec` is fully self-contained and JSON-round-trippable:
app + deterministic input feed + eligibility expectations + the strategy
knobs that exposed a divergence. That is the fixture format under
``tests/fixtures/fuzz/`` (the known-bad-set pattern: a shrunk
divergence is committed as data the regression suite replays).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

ATTR_TYPES = ("int", "long", "float", "double", "string", "bool")

_NP_DTYPES = {
    "int": np.int32, "long": np.int64, "float": np.float32,
    "double": np.float64, "bool": np.bool_, "string": object,
}


def np_dtype(attr_type: str):
    """numpy dtype for one SiddhiQL attribute type (string = object)."""
    return _NP_DTYPES[attr_type]


@dataclass
class StreamSpec:
    """One input stream definition: name + typed attributes."""

    name: str
    attrs: List[Tuple[str, str]]          # (attr_name, attr_type)

    def attr_type(self, attr: str) -> str:
        for n, t in self.attrs:
            if n == attr:
                return t
        raise KeyError(f"{self.name} has no attribute {attr!r}")

    def render(self) -> str:
        cols = ", ".join(f"{n} {t}" for n, t in self.attrs)
        return f"define stream {self.name} ({cols});"


@dataclass
class JoinSpec:
    """Stream-stream window join: sides, windows, key, optional extras."""

    left_stream: str
    right_stream: str
    left_window: Optional[List] = None    # [kind, param] or None
    right_window: Optional[List] = None
    key_attr: str = "sym"                 # equality attr (both sides)
    join_type: str = "join"               # 'join' | 'left outer join'
    residual: Optional[str] = None        # extra on-condition conjunct
    unidirectional: bool = False


@dataclass
class PatternSpec:
    """Two-stage NFA pattern: every e1=A[c1] -> e2=B[c2]."""

    first_stream: str
    second_stream: str
    first_cond: str
    second_cond: str
    every: bool = True


@dataclass
class QuerySpec:
    """One query: a typed composition of optional clauses."""

    name: str
    kind: str                             # 'single' | 'join' | 'pattern'
    insert_into: str
    from_stream: Optional[str] = None     # single-stream source
    window: Optional[List] = None         # [kind, param] or None
    ts_attr: Optional[str] = None         # externalTime expiry attribute
    filter: Optional[str] = None          # condition text (no brackets)
    select_items: List[List[str]] = field(default_factory=list)  # [expr, alias]
    group_by: Optional[List[str]] = None
    having: Optional[str] = None
    partition_key: Optional[str] = None   # wraps query in a partition
    join: Optional[JoinSpec] = None
    pattern: Optional[PatternSpec] = None
    # generator-declared eligibility expectations the runner must verify:
    # {surface: ReasonCode-value} — only surfaces the generator is SURE
    # about (a mismatch is a silent strategy fallback = a finding)
    expect: Dict[str, str] = field(default_factory=dict)

    # ------------------------------------------------------------ render

    def _window_clause(self, win: Optional[List],
                      ts_attr: Optional[str]) -> str:
        from siddhi_tpu_torch.fuzz.determinism import window_clause

        if win is None:
            return ""
        return window_clause(win[0], win[1], ts_attr)

    def _select_clause(self) -> str:
        items = ", ".join(f"{expr} as {alias}" if alias and alias != expr
                          else expr
                          for expr, alias in self.select_items)
        sel = f"select {items}"
        if self.group_by:
            sel += f" group by {', '.join(self.group_by)}"
        if self.having:
            sel += f" having {self.having}"
        return sel

    def render(self) -> str:
        if self.kind == "join":
            j = self.join
            lw = self._window_clause(j.left_window, self.ts_attr)
            rw = self._window_clause(j.right_window, self.ts_attr)
            on = (f"{j.left_stream}.{j.key_attr} == "
                  f"{j.right_stream}.{j.key_attr}")
            if j.residual:
                on += f" and {j.residual}"
            uni = " unidirectional" if j.unidirectional else ""
            body = (f"@info(name='{self.name}') "
                    f"from {j.left_stream}{lw} {j.join_type} "
                    f"{j.right_stream}{rw}{uni} on {on} "
                    f"{self._select_clause()} insert into {self.insert_into};")
        elif self.kind == "pattern":
            p = self.pattern
            every = "every " if p.every else ""
            body = (f"@info(name='{self.name}') "
                    f"from {every}e1={p.first_stream}[{p.first_cond}] "
                    f"-> e2={p.second_stream}[{p.second_cond}] "
                    f"{self._select_clause()} insert into {self.insert_into};")
        else:
            flt = f"[{self.filter}]" if self.filter else ""
            win = self._window_clause(self.window, self.ts_attr)
            body = (f"@info(name='{self.name}') "
                    f"from {self.from_stream}{flt}{win} "
                    f"{self._select_clause()} insert into {self.insert_into};")
        if self.partition_key:
            src = self.from_stream if self.kind == "single" \
                else self.join.left_stream
            keys = f"{self.partition_key} of {src}"
            if self.kind == "join" \
                    and self.join.right_stream != src:
                keys += f", {self.partition_key} of {self.join.right_stream}"
            return f"partition with ({keys})\nbegin\n  {body}\nend;"
        return body

    # ------------------------------------------------------------ shape

    def clause_count(self) -> int:
        """How many grammar clauses this query is built from — the
        shrinker's minimality metric (a planted divergence must shrink
        to <= 3 clauses). The mandatory from/select skeleton counts 1."""
        n = 1
        for present in (self.window, self.filter, self.group_by,
                        self.having, self.partition_key):
            if present:
                n += 1
        if self.join is not None:
            n += 1                          # the join clause itself
            if self.join.left_window is not None:
                n += 1
            if self.join.right_window is not None:
                n += 1
            if self.join.residual:
                n += 1
        if self.pattern is not None:
            n += 1
        return n


@dataclass
class CaseSpec:
    """One self-contained fuzz case: schemas + queries + input feed."""

    seed: int
    streams: List[StreamSpec]
    queries: List[QuerySpec]
    # deterministic feed: (stream_name, timestamp, [values]) — one entry
    # per event, timestamps strictly increasing across the whole feed
    events: List[List] = field(default_factory=list)
    notes: str = ""

    def app_text(self) -> str:
        parts = [s.render() for s in self.streams]
        parts += [q.render() for q in self.queries]
        return "\n".join(parts) + "\n"

    def out_streams(self) -> List[str]:
        # dedupe, preserve order
        seen, out = set(), []
        for q in self.queries:
            if q.insert_into not in seen:
                seen.add(q.insert_into)
                out.append(q.insert_into)
        return out

    def stream(self, name: str) -> StreamSpec:
        for s in self.streams:
            if s.name == name:
                return s
        raise KeyError(name)

    def clause_count(self) -> int:
        return sum(q.clause_count() for q in self.queries)

    # ------------------------------------------------------- serialization

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "CaseSpec":
        streams = [StreamSpec(s["name"], [tuple(a) for a in s["attrs"]])
                   for s in d["streams"]]
        queries = []
        for q in d["queries"]:
            join = JoinSpec(**q["join"]) if q.get("join") else None
            pattern = PatternSpec(**q["pattern"]) if q.get("pattern") else None
            q2 = {k: v for k, v in q.items() if k not in ("join", "pattern")}
            queries.append(QuerySpec(join=join, pattern=pattern, **q2))
        return cls(seed=d["seed"], streams=streams, queries=queries,
                   events=[list(e) for e in d["events"]],
                   notes=d.get("notes", ""))

    @classmethod
    def from_json(cls, text: str) -> "CaseSpec":
        return cls.from_dict(json.loads(text))
