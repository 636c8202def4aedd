"""Seeded typed SiddhiQL generator: random-but-valid by construction.

Counterpart of ``siddhi_tpu/fuzz/generator.py``, a copy: the same
``random.Random`` draws in the same order, so a seed gives the same
``CaseSpec`` JSON as the reference, expectations included.

The "Stream Types" discipline (PAPERS.md): every fragment is composed
against a typed stream context — a filter only compares attributes of
compatible types, a projection's expression types are computed as it is
built (so chained queries know their derived stream's schema), an
aggregation only folds numeric attributes, a join key is an attribute
both sides share at the same type. A generated app therefore compiles
by construction; "100 seeded cases all compile" is a regression test,
not a hope.

Determinism: windows are drawn exclusively from
``fuzz.determinism.DETERMINISTIC_WINDOWS`` (count-driven or
externalTime data-driven expiry) so two runs of one feed are
bit-comparable — the wall-clock window lesson is enforced here, at the
grammar, not rediscovered per check.

Every generated query carries eligibility EXPECTATIONS for the surfaces
the grammar is sure about (e.g. "partitioned + keyed length window =>
route-eligible", "two-stage pattern => route NFA_QUERY"): the runner
asserts the engine's census agrees, so a silent strategy fallback — an
eligible shape quietly taking the legacy path — is a detected coverage
gap even when outputs match.

Reproducible: same seed => same corpus, byte for byte (``random.Random``
only, no numpy RNG, no wall clock).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from siddhi_tpu_torch.core.eligibility import (
    SURFACE_JOIN_ENGINE,
    SURFACE_JOIN_PIPELINE,
    SURFACE_ROUTE,
    ReasonCode,
)
from siddhi_tpu_torch.fuzz.schema import (
    CaseSpec,
    JoinSpec,
    PatternSpec,
    QuerySpec,
    StreamSpec,
)

_SYMS = ("S0", "S1", "S2", "S3", "S4", "S5")
_NUMERIC = ("int", "long", "float", "double")
_AGGS = ("sum", "count", "avg", "min", "max")


class CaseGenerator:
    """Seeded generator of :class:`CaseSpec` corpora."""

    def __init__(self, seed: int, events_per_case: int = 80,
                 max_queries: int = 4):
        self.seed = seed
        self.events_per_case = events_per_case
        self.max_queries = max_queries

    def corpus(self, n_cases: int) -> List[CaseSpec]:
        return [self.case(i) for i in range(n_cases)]

    def case(self, index: int) -> CaseSpec:
        """Case ``index`` of this generator's corpus — a pure function
        of (seed, index)."""
        rng = random.Random((self.seed << 20) ^ index)
        streams = self._streams(rng)
        ctx = _TypedContext(streams)
        n_q = rng.randint(1, self.max_queries)
        queries = [self._query(rng, ctx, i) for i in range(n_q)]
        events = self._events(rng, streams)
        return CaseSpec(seed=self.seed, streams=streams, queries=queries,
                        events=events,
                        notes=f"generator seed={self.seed} case={index}")

    # ------------------------------------------------------------ schemas

    def _streams(self, rng: random.Random) -> List[StreamSpec]:
        out = []
        for i in range(rng.randint(1, 3)):
            # every stream shares the spine the grammar composes
            # against: ts (externalTime expiry clock), sym (join /
            # partition / group key), plus 2-4 random typed value attrs
            attrs: List[Tuple[str, str]] = [("ts", "long"), ("sym", "string")]
            attrs.append(("v0", rng.choice(("int", "long"))))
            for j in range(1, rng.randint(2, 4)):
                attrs.append((f"v{j}", rng.choice(
                    ("int", "long", "float", "double", "bool", "string"))))
            out.append(StreamSpec(f"In{i}", attrs))
        return out

    # ------------------------------------------------------------ queries

    def _query(self, rng: random.Random, ctx: "_TypedContext",
               i: int) -> QuerySpec:
        roll = rng.random()
        if roll < 0.18 and len(ctx.inputs) >= 2:
            return self._pattern_query(rng, ctx, i)
        if roll < 0.45 and len(ctx.inputs) >= 2:
            return self._join_query(rng, ctx, i)
        return self._single_query(rng, ctx, i)

    def _single_query(self, rng: random.Random, ctx: "_TypedContext",
                      i: int) -> QuerySpec:
        src = ctx.pick_source(rng)
        attrs = dict(ctx.schema(src))
        partitioned = rng.random() < 0.35 and "sym" in attrs \
            and src in ctx.inputs
        # windows: deterministic kinds only (fuzz.determinism); the
        # externalTime variants need the ts clock attribute
        win: Optional[List] = None
        ts_attr = "ts" if attrs.get("ts") == "long" else None
        w = rng.random()
        if partitioned:
            # keyed variants: length (route-eligible), lengthBatch /
            # externalTime (deterministic but not global-aware yet)
            if w < 0.5:
                win = ["length", rng.choice((4, 8, 16))]
            elif w < 0.7:
                win = ["lengthBatch", rng.choice((2, 4))]
            elif w < 0.85 and ts_attr:
                win = ["externalTime", rng.randint(1, 3)]
        else:
            if w < 0.35:
                win = ["length", rng.choice((4, 8, 16))]
            elif w < 0.55:
                win = ["lengthBatch", rng.choice((2, 4))]
            elif w < 0.75 and ts_attr:
                win = [rng.choice(("externalTime", "externalTimeBatch")),
                       rng.randint(1, 3)]
        flt = self._filter(rng, attrs) if rng.random() < 0.5 else None
        group = None
        if rng.random() < 0.45 and "sym" in attrs:
            group = ["sym"]
        select, out_schema, agg_aliases = self._select(rng, attrs, group)
        having = None
        if group and agg_aliases and rng.random() < 0.3:
            having = f"{rng.choice(agg_aliases)} > {rng.randint(1, 20)}"
        q = QuerySpec(
            name=f"q{i}", kind="single", insert_into=f"Out{i}",
            from_stream=src, window=win,
            ts_attr=ts_attr if win and win[0].startswith("external") else None,
            filter=flt, select_items=select, group_by=group, having=having,
            partition_key="sym" if partitioned else None)
        q.expect[SURFACE_ROUTE] = self._route_expectation(
            partitioned, win, group).value
        ctx.define_derived(q.insert_into, out_schema)
        return q

    def _route_expectation(self, partitioned: bool, win: Optional[List],
                           group) -> ReasonCode:
        """The v1 device-routing contract the generator KNOWS (mirrors
        ``parallel/mesh.route_ineligibility``; asserting the mirror is
        the point — drift = silent fallback)."""
        if partitioned:
            if win is None or win[0] == "length":
                return ReasonCode.ELIGIBLE
            return ReasonCode.WINDOW_NOT_GLOBAL_AWARE
        if win is not None:
            # the engine classifies window KIND before global-ness: any
            # non-keyed-length stage (plain Length/Time rings, the fused
            # sliding-agg stage a grouped window folds into) reports
            # WINDOW_NOT_GLOBAL_AWARE
            return ReasonCode.WINDOW_NOT_GLOBAL_AWARE
        if group:
            return ReasonCode.ELIGIBLE       # grouped agg, no window
        return ReasonCode.UNKEYED

    def _join_query(self, rng: random.Random, ctx: "_TypedContext",
                    i: int) -> QuerySpec:
        left, right = rng.sample(ctx.inputs, 2)
        la, ra = dict(ctx.schema(left)), dict(ctx.schema(right))
        partitioned = rng.random() < 0.25
        if partitioned:
            lwin: List = ["length", rng.choice((4, 8))]
            rwin: List = ["length", rng.choice((4, 8))]
        else:
            lwin = self._join_window(rng, la)
            rwin = self._join_window(rng, ra)
        join_type = "left outer join" if rng.random() < 0.3 else "join"
        uni = join_type == "join" and rng.random() < 0.2
        residual = None
        lnum = _numeric_attrs(la)
        rnum = _numeric_attrs(ra)
        if not partitioned and lnum and rnum and rng.random() < 0.35:
            residual = (f"{left}.{rng.choice(lnum)} > "
                        f"{right}.{rng.choice(rnum)}")
        group = None
        select: List[List[str]] = [[f"{left}.sym", "sym"]]
        agg_src = rng.choice(rnum) if rnum else None
        if rng.random() < 0.25 and agg_src:
            group = [f"{left}.sym"]
            select.append([f"sum({right}.{agg_src})", "total"])
        else:
            if lnum:
                a = rng.choice(lnum)
                select.append([f"{left}.{a}", f"l_{a}"])
            if rnum and join_type == "join":
                a = rng.choice(rnum)
                select.append([f"{right}.{a}", f"r_{a}"])
        q = QuerySpec(
            name=f"q{i}", kind="join", insert_into=f"Out{i}",
            ts_attr="ts",
            select_items=select, group_by=group,
            partition_key="sym" if partitioned else None,
            join=JoinSpec(left_stream=left, right_stream=right,
                          left_window=lwin, right_window=rwin,
                          key_attr="sym", join_type=join_type,
                          residual=residual, unidirectional=uni))
        if partitioned:
            q.expect[SURFACE_JOIN_ENGINE] = ReasonCode.PARTITIONED.value
            # a grouped selector forces the host keyed-select split even
            # inside a partition, which blocks the routed join path
            q.expect[SURFACE_ROUTE] = (
                ReasonCode.GROUPED_SELECT if group
                else ReasonCode.ELIGIBLE).value
        else:
            q.expect[SURFACE_JOIN_ENGINE] = ReasonCode.ELIGIBLE.value
            q.expect[SURFACE_ROUTE] = ReasonCode.JOIN_UNPARTITIONED.value
            q.expect[SURFACE_JOIN_PIPELINE] = (
                ReasonCode.GROUPED_SELECT if group
                else ReasonCode.ELIGIBLE).value
        return q

    def _join_window(self, rng: random.Random, attrs: Dict[str, str]) -> List:
        if attrs.get("ts") == "long" and rng.random() < 0.3:
            return ["externalTime", rng.randint(1, 2)]
        return ["length", rng.choice((4, 8, 16))]

    def _pattern_query(self, rng: random.Random, ctx: "_TypedContext",
                       i: int) -> QuerySpec:
        first, second = rng.sample(ctx.inputs, 2)
        fa, sa = dict(ctx.schema(first)), dict(ctx.schema(second))
        fnum, snum = _numeric_attrs(fa), _numeric_attrs(sa)
        c1 = (f"{rng.choice(fnum)} > {rng.randint(0, 30)}" if fnum
              else "sym == 'S0'")
        if snum and fnum and rng.random() < 0.5:
            c2 = f"{rng.choice(snum)} > e1.{rng.choice(fnum)}"
        else:
            c2 = (f"{rng.choice(snum)} > {rng.randint(0, 30)}" if snum
                  else "sym == 'S1'")
        select = [["e1.sym", "sym1"]]
        if fnum:
            select.append([f"e1.{rng.choice(fnum)}", "a1"])
        if snum:
            select.append([f"e2.{rng.choice(snum)}", "a2"])
        q = QuerySpec(
            name=f"q{i}", kind="pattern", insert_into=f"Out{i}",
            select_items=select,
            pattern=PatternSpec(first_stream=first, second_stream=second,
                                first_cond=c1, second_cond=c2,
                                every=rng.random() < 0.7))
        q.expect[SURFACE_ROUTE] = ReasonCode.NFA_QUERY.value
        return q

    # ----------------------------------------------------- typed fragments

    def _filter(self, rng: random.Random,
                attrs: Dict[str, str]) -> Optional[str]:
        terms = []
        num = _numeric_attrs(attrs)
        if num:
            terms.append(f"{rng.choice(num)} > {rng.randint(0, 40)}")
        if "sym" in attrs and rng.random() < 0.5:
            op = rng.choice(("==", "!="))
            terms.append(f"sym {op} '{rng.choice(_SYMS[:4])}'")
        bools = [n for n, t in attrs.items() if t == "bool"]
        if bools and rng.random() < 0.4:
            terms.append(f"{rng.choice(bools)} == true")
        if not terms:
            return None
        rng.shuffle(terms)
        take = terms[:rng.randint(1, min(2, len(terms)))]
        return f" {rng.choice(('and', 'or'))} ".join(take) \
            if len(take) > 1 else take[0]

    def _select(self, rng: random.Random, attrs: Dict[str, str],
                group) -> Tuple[List[List[str]], List[Tuple[str, str]],
                                List[str]]:
        """Typed projection/aggregation items. Returns (select_items,
        derived schema, aggregate aliases)."""
        from siddhi_tpu_torch.ops.aggregators import agg_result_type
        from siddhi_tpu_torch.query_api.definitions import AttrType

        items: List[List[str]] = []
        schema: List[Tuple[str, str]] = []
        agg_aliases: List[str] = []
        num = _numeric_attrs(attrs)
        if group:
            for g in group:
                items.append([g, g])
                schema.append((g, attrs[g]))
            for k in range(rng.randint(1, 2)):
                if num:
                    kind, src = rng.choice(_AGGS), rng.choice(num)
                elif "ts" in attrs:
                    kind, src = rng.choice(_AGGS), "ts"
                else:
                    kind, src = "count", group[0]
                alias = f"agg{k}"
                items.append([f"{kind}({src})", alias])
                rt = agg_result_type(kind, AttrType(attrs[src]))
                schema.append((alias, rt.value))
                agg_aliases.append(alias)
            return items, schema, agg_aliases
        # plain projection: a subset of attrs + at most one computed expr
        names = [n for n in attrs]
        rng.shuffle(names)
        for n in names[:rng.randint(1, max(1, len(names) - 1))]:
            items.append([n, n])
            schema.append((n, attrs[n]))
        ints = [n for n, t in attrs.items() if t in ("int", "long")]
        if ints and rng.random() < 0.45:
            roll = rng.random()
            a = rng.choice(ints)
            if roll < 0.4 and len(ints) >= 2:
                b = rng.choice([x for x in ints if x != a] or [a])
                expr, et = f"{a} + {b}", _promote_int(attrs[a], attrs[b])
            elif roll < 0.7:
                expr, et = f"{a} * {rng.randint(2, 5)}", attrs[a]
            else:
                lo, hi = sorted((rng.randint(0, 20), rng.randint(21, 50)))
                expr = f"ifThenElse({a} > {lo}, {a}, {hi})"
                et = attrs[a]
            items.append([expr, "calc"])
            schema.append(("calc", et))
        if not items:
            items.append(["sym", "sym"])
            schema.append(("sym", "string"))
        return items, schema, agg_aliases

    # ------------------------------------------------------------- events

    def _events(self, rng: random.Random,
                streams: List[StreamSpec]) -> List[List]:
        events: List[List] = []
        ts = 1_000_000
        for _ in range(self.events_per_case):
            s = rng.choice(streams)
            ts += rng.randint(1, 40)
            row = []
            for name, t in s.attrs:
                if name == "ts":
                    row.append(ts)
                elif t == "string":
                    row.append(rng.choice(_SYMS))
                elif t == "bool":
                    row.append(rng.random() < 0.5)
                elif t in ("float", "double"):
                    # multiples of 0.25: exactly representable, so sums
                    # stay exact and cross-strategy diffs are noise-free
                    row.append(rng.randint(0, 400) * 0.25)
                else:
                    row.append(rng.randint(0, 50))
            events.append([s.name, ts, row])
        return events


class _TypedContext:
    """The generator's stream-typing environment: input schemas plus the
    derived schemas of already-generated queries (chained pipelines)."""

    def __init__(self, streams: List[StreamSpec]):
        self.inputs = [s.name for s in streams]
        self._schemas: Dict[str, List[Tuple[str, str]]] = {
            s.name: list(s.attrs) for s in streams}
        self._derived: List[str] = []

    def schema(self, name: str) -> List[Tuple[str, str]]:
        return self._schemas[name]

    def define_derived(self, name: str, schema: List[Tuple[str, str]]):
        if name not in self._schemas:
            self._schemas[name] = schema
            self._derived.append(name)

    def pick_source(self, rng: random.Random) -> str:
        # mostly inputs; occasionally chain off a derived stream
        if self._derived and rng.random() < 0.2:
            return rng.choice(self._derived)
        return rng.choice(self.inputs)


def _numeric_attrs(attrs: Dict[str, str]) -> List[str]:
    return [n for n, t in attrs.items() if t in _NUMERIC and n != "ts"]


def _promote_int(a: str, b: str) -> str:
    return "long" if "long" in (a, b) else "int"
