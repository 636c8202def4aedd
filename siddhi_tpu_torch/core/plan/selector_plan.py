"""Selector planning: select / group by / having -> device stage.

Counterpart of ``siddhi_tpu/core/plan/selector_plan.py``. Aggregator call
sites in the selection are split out and computed by segmented scans
(``ops/aggregators.py``); the remaining scalar expressions become
projections over the batch columns.

Semantics reproduced (reference ``QuerySelector.processGroupBy``):
- every CURRENT/EXPIRED row updates aggregators and yields an output row;
- RESET rows reset all group states and yield nothing;
- TIMER rows are dropped;
- currentOn/expiredOn filtering, then ``having``.

``order by``, ``limit``/``offset`` and batch-window chunk collapsing are
not ported yet and raise ``CompileError``.
"""

from __future__ import annotations

from dataclasses import dataclass
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
)
from siddhi_tpu_torch.query_api.definitions import AttrType
from siddhi_tpu_torch.query_api.execution import Selector
from siddhi_tpu_torch.query_api.expressions import (
    AttributeFunction,
    Expression,
    Variable,
)

CURRENT, EXPIRED, TIMER, RESET = 0, 1, 2, 3
GK_KEY = "__gk__"


def _rewrite_aggregators(expr: Expression, specs: List[agg_ops.AggSpec],
                         resolver: Resolver) -> Expression:
    """Replace aggregator calls with synthetic Variables bound to scan
    output columns."""
    if isinstance(expr, AttributeFunction) and not expr.namespace \
            and expr.name.lower() in _KNOWN_AGGREGATORS:
        kind = expr.name.lower()
        agg_ops.check_ported(kind)
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
        if kind in ("sum", "avg") and arg_t not in (
                AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE):
            raise CompileError(
                f"{kind}() expects a numeric attribute but found "
                f"{arg_t.value if arg_t else None}")
        out_key = f"__agg{len(specs)}__"
        specs.append(agg_ops.AggSpec(
            kind=kind, arg_fn=arg_f, arg_type=arg_t, out_key=out_key,
            out_type=agg_ops.agg_result_type(kind, arg_t)))
        return Variable(attribute_name=out_key)
    for attr_name in ("left", "right", "expression"):
        child = getattr(expr, attr_name, None)
        if isinstance(child, Expression):
            setattr(expr, attr_name, _rewrite_aggregators(child, specs, resolver))
    if isinstance(expr, AttributeFunction):
        expr.parameters = [_rewrite_aggregators(p, specs, resolver)
                           for p in expr.parameters]
    return expr


# every aggregator name the reference knows, so an unported one is named
# as such instead of failing as an unknown function
_KNOWN_AGGREGATORS = ("sum", "count", "avg", "stddev", "and", "or", "min",
                      "max", "minforever", "maxforever", "distinctcount",
                      "unionset")


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
    num_keys: int = 16

    def init_state(self, device) -> dict:
        return agg_ops.init_agg_state(self.specs, self.num_keys, device)

    def apply(self, state: dict, cols: dict, ctx: dict):
        if self.specs:
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
        if OKEY_KEY in cols:
            # device routing: the window's emission-order key rides to the
            # route wrapper's cross-shard merge
            out[OKEY_KEY] = cols[OKEY_KEY]
        elif RIDX_KEY in cols:
            # no window stage: rows are input-aligned, so the original
            # batch position IS the emission order
            out[OKEY_KEY] = cols[RIDX_KEY]
        B = ts.shape[0]
        xp = ctx["xp"]
        for name, fn, _t in self.projections:
            v, m = fn(cols, ctx)
            out[name] = xp.asarray(v).expand(B)
            if m is not None:
                # scalar masks (typed null literals) take row shape
                out[name + "?"] = xp.asarray(m).expand(B)

        types = cols[TYPE_KEY]
        type_ok = (((types == CURRENT) & self.current_on)
                   | ((types == EXPIRED) & self.expired_on))
        valid = cols[VALID_KEY] & type_ok
        if self.having_fn is not None:
            valid = valid & self.having_fn(out, ctx)
        out[VALID_KEY] = valid
        return state, out


def plan_selector(selector: Selector, input_attrs: List[Tuple[str, AttrType]],
                  resolver: Resolver, output_event_type: str,
                  dictionary) -> SelectorPlan:
    if selector.order_by_list or selector.limit is not None \
            or selector.offset is not None:
        raise CompileError(
            "order by / limit / offset are not ported to siddhi_tpu_torch yet")
    specs: List[agg_ops.AggSpec] = []
    selections: List[Tuple[str, Expression]] = []
    if selector.select_all or not selector.selection_list:
        for name, _t in input_attrs:
            selections.append((name, Variable(attribute_name=name)))
    else:
        for oa in selector.selection_list:
            selections.append((oa.name, oa.expression))

    projections = []
    output_attrs: List[Tuple[str, AttrType]] = []
    for name, expr in selections:
        rewritten = _rewrite_aggregators(expr, specs, resolver)
        _augment_synthetic(resolver, specs)
        fn, t = compile_expr(rewritten, resolver)
        if t == AttrType.OBJECT:
            raise CompileError("set-valued outputs are not ported yet")
        projections.append((name, fn, t))
        output_attrs.append((name, t))

    having_fn = None
    if selector.having is not None:
        out_resolver = OutputColsResolver(output_attrs, dictionary, fallback=resolver)
        having = _rewrite_aggregators(selector.having, specs, resolver)
        _augment_synthetic(resolver, specs)
        having_fn = compile_condition(having, out_resolver)

    return SelectorPlan(
        specs=specs,
        projections=projections,
        output_attrs=output_attrs,
        having_fn=having_fn,
        group_by=bool(selector.group_by_list),
        current_on=output_event_type in ("current", "all"),
        expired_on=output_event_type in ("expired", "all"),
    )


def _augment_synthetic(resolver, specs):
    synthetic = getattr(resolver, "synthetic", None)
    if synthetic is not None:
        for s in specs:
            synthetic[s.out_key] = s.out_type
