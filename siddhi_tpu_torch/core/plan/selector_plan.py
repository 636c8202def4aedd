"""Selector planning: select / group by / having / order by / limit ->
device stage.

Counterpart of ``siddhi_tpu/core/plan/selector_plan.py``. Aggregator call
sites in the selection are split out and computed by segmented scans
(``ops/aggregators.py``), or upstream by the fused window stage
(``ops/fused_agg.py``, precomputed mode); the remaining scalar
expressions become projections over the batch columns.

Semantics reproduced (reference ``QuerySelector.processGroupBy``):
- every CURRENT/EXPIRED row updates aggregators and yields an output row;
- RESET rows reset all group states and yield nothing;
- TIMER rows are dropped;
- currentOn/expiredOn filtering, then ``having``;
- ``order by`` / ``offset`` / ``limit`` apply per output chunk (batch),
  limit after the sort.

Set-valued (OBJECT) outputs carry their element type (``object_meta``)
and, for multi-element sets, their '#set'/'#setm' companions
(``set_cols``, ``object_multi``); ``uuid()`` outputs are filled on the
host after the step (``uuid_cols``). Chunks of a batch window keep only
the last valid row per (flush epoch, group) when the selection
aggregates or groups (``processInBatchGroupBy``/``NoGroupBy``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from siddhi_tpu_torch.core.plan.resolvers import OutputColsResolver
from siddhi_tpu_torch.ops import aggregators as agg_ops
from siddhi_tpu_torch.ops.expressions import (
    OKEY_KEY,
    PK_KEY,
    RIDX_KEY,
    TS_KEY,
    TYPE_KEY,
    VALID_KEY,
    CompileError,
    Resolver,
    compile_condition,
    compile_expr,
    take_object_elem_marker,
    take_uuid_marker,
)
from siddhi_tpu_torch.ops.windows import FLUSH_KEY
from siddhi_tpu_torch.query_api.definitions import AttrType
from siddhi_tpu_torch.query_api.execution import Selector
from siddhi_tpu_torch.query_api.expressions import (
    AttributeFunction,
    Expression,
    Variable,
)

CURRENT, EXPIRED, TIMER, RESET = 0, 1, 2, 3
GK_KEY = "__gk__"
STR_RANK = "__strrank__"   # [dict capacity] lexicographic rank per string id
# prefix of an order-by input column carried past the step (order_columns)
ORDER_COL = "__order__"


def _rewrite_aggregators(expr: Expression, specs: List[agg_ops.AggSpec],
                         resolver: Resolver) -> Expression:
    """Replace aggregator calls with synthetic Variables bound to scan
    output columns."""
    if isinstance(expr, AttributeFunction) and not expr.namespace \
            and expr.name.lower() in agg_ops.supported_aggregators():
        kind = expr.name.lower()
        if kind == "count":
            if len(expr.parameters) > 1:
                raise CompileError("count() accepts at most one argument")
        elif len(expr.parameters) != 1:
            raise CompileError(f"{kind}() expects exactly one argument, "
                               f"found {len(expr.parameters)}")
        if expr.parameters:
            arg_f, arg_t = compile_expr(expr.parameters[0], resolver)
        else:
            arg_f, arg_t = None, None
        if kind in ("sum", "avg", "stddev", "min", "max",
                    "minforever", "maxforever") and arg_t not in (
                AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE):
            raise CompileError(
                f"{kind}() expects a numeric attribute but found "
                f"{arg_t.value if arg_t else None}")
        if kind in ("and", "or") and arg_t != AttrType.BOOL:
            raise CompileError(
                f"{kind}() expects a bool attribute but found "
                f"{arg_t.value if arg_t else None}")
        out_key = f"__agg{len(specs)}__"
        spec = agg_ops.AggSpec(
            kind=kind, arg_fn=arg_f, arg_type=arg_t, out_key=out_key,
            out_type=agg_ops.agg_result_type(kind, arg_t))
        if kind == "unionset":
            if arg_t != AttrType.OBJECT:
                raise CompileError(
                    "Parameter passed to unionSet aggregator should be of "
                    f"type object but found: {arg_t.value if arg_t else None}")
            # element type for decode: a nested createSet() marks it; a
            # bare set attribute carries it on its stream definition (and
            # its column key locates the '#set' companions to re-union)
            spec.elem_type = take_object_elem_marker()
            param = expr.parameters[0]
            if isinstance(param, Variable):
                spec.arg_key = resolver.resolve(param).key
                spec.arg_is_multi = _is_multi(resolver, param)
                if spec.elem_type is None:
                    spec.elem_type = _elem_type_of(resolver, param)
        specs.append(spec)
        return Variable(attribute_name=out_key)
    for attr_name in ("left", "right", "expression"):
        child = getattr(expr, attr_name, None)
        if isinstance(child, Expression):
            setattr(expr, attr_name, _rewrite_aggregators(child, specs, resolver))
    if isinstance(expr, AttributeFunction):
        expr.parameters = [_rewrite_aggregators(p, specs, resolver)
                           for p in expr.parameters]
    return expr


def _elem_type_of(resolver, var: Variable):
    """Set-element type of an object attribute, recorded on its stream
    definition by the app assembler (None = decode raw codes)."""
    defn = getattr(resolver, "definition", None)
    meta = getattr(defn, "object_elem_types", None)
    return meta.get(var.attribute_name) if meta else None


def _is_multi(resolver, var: Variable) -> bool:
    """Whether an object attribute is a multi-element set (a unionSet
    output), per its stream definition's assembler metadata."""
    defn = getattr(resolver, "definition", None)
    multi = getattr(defn, "object_multi_attrs", None)
    return bool(multi) and var.attribute_name in multi


@dataclass
class SelectorPlan:
    """Compiled selector; ``apply`` runs inside the query step."""

    specs: List[agg_ops.AggSpec]
    projections: List[Tuple[str, Callable, AttrType]]  # (out name, fn, type)
    output_attrs: List[Tuple[str, AttrType]]
    having_fn: Optional[Callable]
    group_by: bool
    current_on: bool
    expired_on: bool
    order_by: List[Tuple[str, bool, bool]]  # (out col, descending, is_str)
    limit: Optional[int]
    offset: Optional[int]
    batch_mode: bool = False  # upstream emits batch chunks (batch windows)
    num_keys: int = 16
    # a fused upstream stage (ops/fused_agg.py) already computed the
    # aggregate columns: no state, no scans, just project and filter
    precomputed: bool = False
    # output columns whose value is a host-generated UUID per row (the
    # step emits placeholders; QueryRuntime._emit fills them)
    uuid_cols: List[str] = field(default_factory=list)
    # OBJECT set outputs: (out name, source column key) pairs whose
    # '#set'/'#setm' companions ride along, and out name -> element
    # AttrType for event decode (None = raw int codes)
    set_cols: List[Tuple[str, str]] = field(default_factory=list)
    object_meta: Dict[str, Optional[AttrType]] = field(default_factory=dict)
    # outputs that are multi-element sets (unionSet results): their base
    # column is the live count; a singleton's is the element code
    object_multi: List[str] = field(default_factory=list)
    # output positions whose projection is an aggregator call: they pick
    # the snapshot rate limiter's variant
    # (WrappedSnapshotOutputRateLimiter.java:67-74)
    agg_positions: List[int] = field(default_factory=list)
    # the group-by Variables (fan-out fusion compares them to share one
    # GroupKeyer across sibling queries: core/plan/fanout_plan.py)
    group_key_exprs: List = field(default_factory=list)

    # the selector's own ops make no host read (its aggregators and
    # compiled expressions declare theirs: ``ops/aggregators.capturable``,
    # ``ops/distinct.capturable``, ``ops/expressions.capturable``), so a
    # fused fan-out step may hold it inside a CUDA graph
    capturable = True

    @property
    def contains_aggregator(self) -> bool:
        return bool(self.specs)

    @property
    def needs_str_rank(self) -> bool:
        """True when an order-by key is a string column: the runtime then
        injects the dictionary's lexicographic rank table as
        cols[STR_RANK]."""
        return any(is_str for _c, _d, is_str in self.order_by)

    def init_state(self, device) -> dict:
        if self.precomputed:
            return {}
        return agg_ops.init_agg_state(self.specs, self.num_keys, device)

    def apply(self, state: dict, cols: dict, ctx: dict):
        if self.specs and not self.precomputed:
            state, cols = agg_ops.apply_aggregators(
                self.specs, state, cols, ctx, self.num_keys)

        ts = cols[TS_KEY]
        out: Dict[str, torch.Tensor] = {
            TS_KEY: ts,
            TYPE_KEY: cols[TYPE_KEY],
            VALID_KEY: cols[VALID_KEY],
            GK_KEY: cols[GK_KEY] if GK_KEY in cols
            else torch.zeros_like(ts, dtype=torch.int32),
        }
        if PK_KEY in cols:
            out[PK_KEY] = cols[PK_KEY]  # partition id rides along to the edge
        if FLUSH_KEY in cols:
            out[FLUSH_KEY] = cols[FLUSH_KEY]
        if OKEY_KEY in cols:
            # device routing: the window's emission-order key rides to the
            # route wrapper's cross-shard merge
            out[OKEY_KEY] = cols[OKEY_KEY]
        elif RIDX_KEY in cols:
            # no window stage: rows are input-aligned, so the original
            # batch position IS the emission order
            out[OKEY_KEY] = cols[RIDX_KEY]
        if "__agg_overflow__" in cols:
            # a full distinctCount/unionSet value table rides the meta
            out["__overflow__"] = cols["__agg_overflow__"]
        B = ts.shape[0]
        xp = ctx["xp"]
        for name, fn, _t in self.projections:
            v, m = fn(cols, ctx)
            out[name] = xp.asarray(v).expand(B)
            if m is not None:
                # scalar masks (typed null literals) take row shape
                out[name + "?"] = xp.asarray(m).expand(B)
        for name, src in self.set_cols:
            # a set-valued output's element snapshot rides beside its count
            for suf in ("#set", "#setm"):
                if src + suf in cols:
                    out[name + suf] = cols[src + suf]

        types = cols[TYPE_KEY]
        type_ok = (((types == CURRENT) & self.current_on)
                   | ((types == EXPIRED) & self.expired_on))
        valid = cols[VALID_KEY] & type_ok
        if self.having_fn is not None:
            valid = valid & self.having_fn(out, ctx)
        if self.batch_mode and (self.contains_aggregator or self.group_by):
            # keep only the last valid row per (flush epoch, group): GK is
            # the partition id of keyless partitioned queries, so per-key
            # flushes in one chunk stay apart
            flush = out.get(FLUSH_KEY)
            if flush is None:
                flush = torch.zeros_like(ts, dtype=torch.int32)
            combo = (flush.to(torch.int64) * (self.num_keys + 1)
                     + out[GK_KEY].to(torch.int64))
            combo = torch.where(valid, combo, 2 ** 62)     # invalid rows last
            order = torch.argsort(combo, stable=True)
            combo_sorted = combo[order]
            seg_last = torch.cat([combo_sorted[1:] != combo_sorted[:-1],
                                  torch.ones(1, dtype=torch.bool, device=ts.device)])
            is_last_sorted = valid[order] & seg_last
            valid = torch.zeros_like(valid)
            valid[order] = is_last_sorted
        out[VALID_KEY] = valid
        return state, self.apply_order_limit(out, cols)

    @property
    def ordered(self) -> bool:
        """order by, limit or offset: a batch-global ordering."""
        return bool(self.order_by) or self.limit is not None or self.offset is not None

    def unordered(self) -> "SelectorPlan":
        """A copy of this plan without order by, limit and offset (the
        key-sharded step across processes orders the merged rows)."""
        plan = copy.copy(self)
        plan.order_by, plan.limit, plan.offset = [], None, None
        return plan

    def order_columns(self, out: dict, cols: dict) -> dict:
        """The order-by input columns the selection does not project,
        under hidden names, for an ordering applied after the step (the
        key-sharded step across processes orders the merged rows)."""
        return {ORDER_COL + col: cols[col] for col, _d, _s in self.order_by
                if col not in out}

    def apply_order_limit(self, out: dict, cols: dict) -> dict:
        """order by, then offset/limit (QuerySelector.java:192-198) over
        the selected rows ``out``; ``cols`` holds the order-by input
        columns the selection does not project (index-aligned with
        ``out``) and the string rank table."""
        valid = out[VALID_KEY]
        if self.order_by:
            overflow = out.pop("__overflow__", None)   # 0-d: not row-shaped
            # the last key of _lexsort is the primary one
            keys = []
            for col, desc, is_str in reversed(self.order_by):
                # order by may name an input column the selection does
                # not project: input rows are index-aligned with outputs
                k = out[col] if col in out else cols[col]
                if is_str:
                    # dictionary ids -> lexicographic ranks (ids count from
                    # arrival; a negative id wraps to the table's end,
                    # which ranks after every string)
                    rank = cols[STR_RANK]
                    k = k.to(torch.int64)
                    k = rank[torch.where(k < 0, k + rank.shape[0], k)]
                if k.dtype == torch.bool:
                    k = k.to(torch.int32)
                keys.append(-k if desc else k)
            keys.append((~valid).to(torch.int32))    # valid rows first
            order = _lexsort(keys)
            out = {k: v[order] for k, v in out.items()}
            valid = out[VALID_KEY]
            if overflow is not None:
                out["__overflow__"] = overflow

        # sort, then offset/limit (QuerySelector.java:192-198)
        if self.limit is not None or self.offset is not None:
            rank = torch.cumsum(valid.to(torch.int32), dim=0) - 1
            lo = self.offset or 0
            keep = rank >= lo
            if self.limit is not None:
                keep = keep & (rank < lo + self.limit)
            out[VALID_KEY] = valid & keep
        return out


def _lexsort(keys):
    """Stable lexicographic order of equal-length [B] keys, the last key
    primary (``jnp.lexsort``)."""
    # least significant key first; each later stable sort keeps the order
    # of the keys before it among its ties
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def plan_selector(selector: Selector, input_attrs: List[Tuple[str, AttrType]],
                  resolver: Resolver, output_event_type: str,
                  dictionary, app_context=None, batch_mode: bool = False,
                  internal_names=frozenset()) -> SelectorPlan:
    specs: List[agg_ops.AggSpec] = []
    selections: List[Tuple[str, Expression]] = []
    if selector.select_all or not selector.selection_list:
        for name, _t in input_attrs:
            if name in internal_names:
                # the planner's synthetic columns (string-cast LUTs) never
                # reach `select *` output
                continue
            selections.append((name, Variable(attribute_name=name)))
    else:
        for oa in selector.selection_list:
            selections.append((oa.name, oa.expression))

    take_uuid_marker()          # clear stale markers (filters compile first)
    take_object_elem_marker()
    projections = []
    output_attrs: List[Tuple[str, AttrType]] = []
    uuid_cols: List[str] = []
    set_cols: List[Tuple[str, str]] = []
    object_meta: Dict[str, Optional[AttrType]] = {}
    object_multi: List[str] = []
    agg_positions: List[int] = []
    for name, expr in selections:
        n_specs = len(specs)
        rewritten = _rewrite_aggregators(expr, specs, resolver)
        _augment_synthetic(resolver, specs)
        if (len(specs) > n_specs and isinstance(rewritten, Variable)
                and rewritten.attribute_name.startswith("__agg")):
            # only a top-level aggregator projection counts: `sum(v) + 0`
            # is a plain output to the snapshot-variant chooser
            agg_positions.append(len(output_attrs))
        fn, t = compile_expr(rewritten, resolver)
        if take_uuid_marker():
            uuid_cols.append(name)      # the host fills fresh UUIDs
        if t == AttrType.OBJECT:
            # set-valued output: its element type (for decode) and source
            # column (for the '#set' companions)
            elem = take_object_elem_marker()     # a createSet in this expr
            if isinstance(rewritten, Variable):
                src = resolver.resolve(rewritten).key
                for s in specs[n_specs:]:
                    if s.out_key == src and s.kind == "unionset":
                        elem = s.elem_type
                        object_multi.append(name)
                set_cols.append((name, src))
                if elem is None:
                    elem = _elem_type_of(resolver, rewritten)
                if name not in object_multi and _is_multi(resolver, rewritten):
                    object_multi.append(name)   # pass-through of a multi set
            object_meta[name] = elem
        projections.append((name, fn, t))
        output_attrs.append((name, t))

    having_fn = None
    out_resolver = OutputColsResolver(output_attrs, dictionary, fallback=resolver)
    if selector.having is not None:
        having = _rewrite_aggregators(selector.having, specs, resolver)
        _augment_synthetic(resolver, specs)
        having_fn = compile_condition(having, out_resolver)

    order_by = []
    for ob in selector.order_by_list:
        ref = out_resolver.resolve(ob.variable)
        # string keys are dictionary ids (arrival order): they sort by the
        # lexicographic rank table the runtime injects per batch
        order_by.append((ref.key, ob.order == "desc",
                         ref.type == AttrType.STRING))

    if app_context is not None:
        for spec in specs:
            if spec.kind in agg_ops.DISTINCT_KINDS:
                spec.distinct_capacity = app_context.distinct_values_capacity

    return SelectorPlan(
        specs=specs,
        projections=projections,
        output_attrs=output_attrs,
        having_fn=having_fn,
        group_by=bool(selector.group_by_list),
        current_on=output_event_type in ("current", "all"),
        expired_on=output_event_type in ("expired", "all"),
        order_by=order_by,
        limit=selector.limit,
        offset=selector.offset,
        batch_mode=batch_mode,
        agg_positions=agg_positions,
        group_key_exprs=list(selector.group_by_list),
        uuid_cols=uuid_cols,
        set_cols=set_cols,
        object_meta=object_meta,
        object_multi=object_multi,
    )


def _augment_synthetic(resolver, specs):
    synthetic = getattr(resolver, "synthetic", None)
    if synthetic is not None:
        for s in specs:
            synthetic[s.out_key] = s.out_type
