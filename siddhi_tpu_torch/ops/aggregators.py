"""Attribute aggregators as segmented prefix scans over dense keyed state.

Counterpart of ``siddhi_tpu/ops/aggregators.py``.

Per aggregator the state is one ``[slots, K]`` tensor, but for
distinctCount and unionSet (below). One batch:
CURRENT rows add, EXPIRED rows subtract, RESET rows reset every group
(the reference's ``cleanGroupByStates``), and every row gets the running
value after it. Rows are sorted by (group, position); persistent state
folds into each group's first row of epoch 0; segment starts and in-batch
RESET epochs block the scan; the last row per group writes back.

Invertible aggregators (sum/count/avg/stdDev/and/or) encode EXPIRED as
negative deltas. min/max fold CURRENT rows only: like the reference they
never drop an evicted value (ROADMAP queue C, R2); minForever/maxForever
fold EXPIRED rows in as well, as the reference's forever executors do.

The reference runs the segmented combine with ``lax.associative_scan``.
Torch has no associative scan, so ``_segmented_scan`` is a log-step
(Hillis-Steele) scan: ceil(log2 B) passes of elementwise torch ops. It
adds in another order than the reference, so float sums agree to
rounding, not bit for bit; min/max are exact.

distinctCount and unionSet keep a per-group table of (value code, count)
slots, ``{vk [K, H], vc [K, H], stamp [K], eb ()}``, and run the distinct
scan of ``ops/distinct.py`` (a hand-written CUDA kernel on the card),
exact and bit for bit with the reference's sequential ``lax.scan``.
unionSet also emits each row's live-element snapshot as ``[B, H]``
'#set'/'#setm' companions, and folds a multi-element input set (an
upstream unionSet's companions) element by element.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.ops import types as T
from siddhi_tpu_torch.ops.distinct import distinct_scan, split_chain
from siddhi_tpu_torch.ops.expressions import (
    TYPE_KEY, VALID_KEY, CompileError, _encode_set_element)
from siddhi_tpu_torch.ops.scatter import put_where_
from siddhi_tpu_torch.query_api.definitions import AttrType

CURRENT, EXPIRED, TIMER, RESET = 0, 1, 2, 3

# every aggregator scan here makes no host read (the distinct kinds launch
# ``ops/distinct``'s kernel, which declares its own), so a fused fan-out
# step may hold them inside a CUDA graph (core/query/step_graph.py)
capturable = True


@dataclass
class _AggDef:
    slots: int
    combine: str  # 'add' | 'min' | 'max'


_AGG_DEFS = {
    "sum": _AggDef(2, "add"),        # (sum, non-null count): empty -> null
    "count": _AggDef(1, "add"),
    "avg": _AggDef(2, "add"),        # (sum, count)
    "stddev": _AggDef(3, "add"),     # (sum, sumsq, count)
    "and": _AggDef(1, "add"),        # false-count
    "or": _AggDef(1, "add"),         # true-count
    # (extreme, non-null count): the presence slot tells "nothing folded"
    # (null) from a datum equal to the fold identity
    "min": _AggDef(2, "min"),
    "max": _AggDef(2, "max"),
    "minforever": _AggDef(2, "min"),
    "maxforever": _AggDef(2, "max"),
    # per-group value tables, run by the distinct scan (_apply_distinct)
    "distinctcount": _AggDef(1, "add"),
    "unionset": _AggDef(1, "add"),
}
DISTINCT_KINDS = ("distinctcount", "unionset")


@dataclass
class AggSpec:
    """One aggregator call site in the selection list."""

    kind: str                      # a key of _AGG_DEFS
    arg_fn: Optional[Callable]     # compiled arg fn(cols, ctx) -> (v, mask); None for count()
    arg_type: Optional[AttrType]
    out_key: str                   # synthetic output column name (__agg<i>__)
    out_type: AttrType = AttrType.DOUBLE
    distinct_capacity: int = 64    # distinctCount/unionSet: value slots H
    arg_key: Optional[str] = None  # unionSet: column key of a bare-Variable
    #                                argument (to find its '#set' companions)
    elem_type: Optional[AttrType] = None  # unionSet: set element type
    arg_is_multi: bool = False     # unionSet: the argument is a multi-element
    #                                set (companions required; base = count)

    @property
    def slots(self) -> int:
        return _AGG_DEFS[self.kind].slots


def agg_result_type(kind: str, arg_type: Optional[AttrType]) -> AttrType:
    """sum: LONG for int/long input, DOUBLE otherwise; count and
    distinctCount: LONG; avg/stdDev: DOUBLE; and/or: BOOL; unionSet:
    OBJECT; min/max keep the input type (reference aggregator executors)."""
    check_ported(kind)
    if kind in ("count", "distinctcount"):
        return AttrType.LONG
    if kind in ("avg", "stddev"):
        return AttrType.DOUBLE
    if kind == "sum":
        if arg_type in (AttrType.INT, AttrType.LONG):
            return AttrType.LONG
        return AttrType.DOUBLE
    if kind in ("and", "or"):
        return AttrType.BOOL
    if kind == "unionset":
        return AttrType.OBJECT
    return arg_type


def _identity(kind: str, dtype) -> np.ndarray:
    d = _AGG_DEFS[kind]
    if d.combine == "add":
        return np.zeros((), dtype)
    floating = np.issubdtype(dtype, np.floating)
    if d.combine == "min":
        return np.asarray(np.inf if floating else np.iinfo(dtype).max, dtype)
    return np.asarray(-np.inf if floating else np.iinfo(dtype).min, dtype)


def _slot_dtype(spec: AggSpec):
    """Accumulation dtype (numpy): Java accumulates sums in long/double;
    the min/max family keeps the argument's own type."""
    if _AGG_DEFS[spec.kind].combine == "add":
        if spec.kind in ("count", "and", "or"):
            return np.dtype(np.int64)
        if spec.kind == "sum" and spec.arg_type in (AttrType.INT, AttrType.LONG):
            return np.dtype(np.int64)
        return np.dtype(np.float64)
    return np.dtype(T.dtype_of(spec.arg_type))


def _slot_identities(kind: str, dtype) -> np.ndarray:
    """[slots] per-slot fold identities (extreme slots pair with an
    add-combined presence counter at identity 0)."""
    d = _AGG_DEFS[kind]
    prim = _identity(kind, dtype)
    if d.combine in ("min", "max"):
        return np.stack([prim, np.zeros((), dtype)])
    return np.broadcast_to(prim, (d.slots,)).copy()


def _combine(kind: str):
    """Combine fn over slot-FIRST tensors [slots, ...]: add, or the
    extreme slot by min/max beside an added presence slot."""
    d = _AGG_DEFS[kind]
    if d.combine == "add":
        return lambda a, b: a + b
    prim = torch.minimum if d.combine == "min" else torch.maximum

    def comb(a, b):
        return torch.cat([prim(a[:1], b[:1]), a[1:] + b[1:]])

    return comb


def _reset_(st: torch.Tensor, kind: str, when: Optional[torch.Tensor] = None) -> None:
    """Write each slot's fold identity into ``st`` [slots, K]: always, or
    where the 0-d bool tensor ``when`` holds (no host sync)."""
    idents = _slot_identities(kind, T.TORCH_TO_NUMPY[st.dtype]).tolist()
    for s, ident in enumerate(idents):
        if when is None:
            st[s].fill_(ident)
        else:
            st[s].masked_fill_(when, ident)


def init_agg_state(specs: List[AggSpec], num_keys: int, device) -> dict:
    """State dict: per spec a [slots, K] tensor at its fold identities, or
    for distinctCount/unionSet an empty value table (``vc`` -1 = never
    used; ``stamp``/``eb`` the lazy-RESET epochs)."""
    state = {}
    for i, spec in enumerate(specs):
        if spec.kind in DISTINCT_KINDS:
            H = spec.distinct_capacity
            state[f"a{i}"] = {
                "vk": torch.zeros((num_keys, H), dtype=torch.int64, device=device),
                "vc": torch.full((num_keys, H), -1, dtype=torch.int32, device=device),
                "stamp": torch.zeros((num_keys,), dtype=torch.int64, device=device),
                "eb": torch.zeros((), dtype=torch.int64, device=device),
            }
            continue
        st = torch.empty((spec.slots, num_keys),
                         dtype=T.to_torch_dtype(_slot_dtype(spec)), device=device)
        _reset_(st, spec.kind)
        state[f"a{i}"] = st
    return state


def _deltas(spec: AggSpec, cols, ctx):
    """Per-event delta tuple [slots, B]; non-participating rows (invalid,
    TIMER, RESET, null argument) contribute the fold identity."""
    types = cols[TYPE_KEY]
    valid = cols[VALID_KEY]
    is_cur = valid & (types == CURRENT)
    is_exp = valid & (types == EXPIRED)
    dtype = T.to_torch_dtype(_slot_dtype(spec))
    v = None
    if spec.arg_fn is not None:
        v, null_mask = spec.arg_fn(cols, ctx)
        v = ctx["xp"].asarray(v).to(dtype).expand(types.shape)
        if null_mask is not None:
            # null arguments leave the state untouched
            is_cur = is_cur & ~null_mask
            is_exp = is_exp & ~null_mask
    k = spec.kind
    sgn = is_cur.to(dtype) - is_exp.to(dtype)
    if k == "count":
        return sgn[None, :]
    if k == "avg":
        return torch.stack([sgn * v, sgn])           # (sum, count)
    if k == "stddev":
        return torch.stack([sgn * v, sgn * v * v, sgn])
    if k in ("and", "or"):
        # and: false-count; or: true-count
        hit = ~v.to(torch.bool) if k == "and" else v.to(torch.bool)
        return ((is_cur & hit).to(dtype) - (is_exp & hit).to(dtype))[None, :]
    if k == "sum":
        d = torch.where(is_cur, v, torch.where(is_exp, -v, torch.zeros_like(v)))
        return torch.stack([d, sgn])                 # (sum, non-null count)
    # min/max family: (extreme, presence); the forever kinds fold EXPIRED too
    folds = is_cur if k in ("min", "max") else is_cur | is_exp
    ident = _identity(k, _slot_dtype(spec)).item()
    return torch.stack([torch.where(folds, v, ident), folds.to(dtype)])


def _output(spec: AggSpec, slots):
    """Running value -> (value, null_mask) per the reference return rules."""
    k = spec.kind
    if k == "sum":
        return slots[0], slots[1] == 0   # null until a non-null folds in
    if k == "count":
        return slots[0], None
    if k == "avg":
        s, c = slots[0], slots[1]
        empty = c == 0
        return s / torch.where(empty, torch.ones_like(c), c), empty
    if k == "stddev":
        s, sq, c = slots
        empty = c == 0
        n = torch.where(empty, torch.ones_like(c), c)
        mean = s / n
        var = torch.clamp(sq / n - mean * mean, min=0.0)
        return torch.sqrt(var), empty
    if k == "and":
        return slots[0] == 0, None
    if k == "or":
        return slots[0] > 0, None
    # min/max family: null until a non-null datum folds in
    return slots[0], slots[1] == 0


def _segmented_scan(comb, blocked, vals):
    """Inclusive segmented scan along the last axis: ``out[:, i]`` combines
    ``vals[:, j..i]`` where j is the last blocked position <= i.
    Hillis-Steele: pass d combines each element with the one d to its left
    (the reference's op: (fa, va) . (fb, vb) = (fa | fb, vb if fb else
    va . vb))."""
    B = vals.shape[-1]
    f, v = blocked, vals
    d = 1
    while d < B:
        v_new = torch.where(f[d:], v[:, d:], comb(v[:, :-d], v[:, d:]))
        f_new = f[d:] | f[:-d]
        v = torch.cat([v[:, :d], v_new], dim=1)
        f = torch.cat([f[:d], f_new])
        d *= 2
    return v


def _apply_distinct(spec: AggSpec, st: dict, cols: dict, ctx: dict,
                    num_keys: int, gk, participates, epoch_before,
                    final_epoch) -> dict:
    """distinctCount / unionSet: the exact per-row running multiset of
    live values per group (reference DistinctCount/UnionSet executors: +1
    on a value's CURRENT, -1 on its EXPIRED; a value is live while its
    count > 0), updating ``st`` in place. Adds the live count column,
    unionSet's '#set'/'#setm' snapshots and ``__agg_overflow__``."""
    types = cols[TYPE_KEY]
    xp = ctx["xp"]
    R = gk.shape[0]
    v, null_m = spec.arg_fn(cols, ctx)
    v = _encode_set_element(xp, v, spec.arg_type).expand(R).contiguous()
    set_in = set_in_m = None
    if spec.kind == "unionset" and spec.arg_key is not None:
        set_in = cols.get(spec.arg_key + "#set")
        if set_in is not None:
            set_in_m = cols[spec.arg_key + "#setm"]
        elif spec.arg_is_multi:
            # the base column of a multi set is its live COUNT: folding
            # counts as element codes would be silent garbage
            raise CompileError(
                f"unionSet over multi-element set attribute "
                f"'{spec.arg_key}' requires its element snapshot, but the "
                f"'#set' companions were dropped (a window between the "
                f"producing unionSet and this one buffers only the base "
                f"column); apply unionSet before the window instead")
    part = participates
    if null_m is not None and set_in is None:
        part = part & ~xp.asarray(null_m)
    delta = torch.where(types == CURRENT, 1, -1).to(torch.int32)
    g = torch.clamp(gk, 0, num_keys - 1)
    ep = st["eb"] + epoch_before.to(torch.int64)
    emit = spec.kind == "unionset"
    vk, vc, stamp = st["vk"], st["vc"], st["stamp"]
    if ctx.get("one_group") and split_chain(1, vk.shape[1], set_in, emit):
        # every row is in group 0: the scan takes that group's row of the
        # tables (a [1, H] view, updated in place), and with it the split chain
        vk, vc, stamp = vk[:1], vc[:1], stamp[:1]
    nd, snap_vk, snap_live, overflow = distinct_scan(
        vk, vc, stamp, g, v, delta, part.expand(R).contiguous(),
        ep, set_in, set_in_m, emit_set=emit)
    st["eb"].add_(final_epoch.to(torch.int64))
    cols[spec.out_key] = nd
    if snap_vk is not None:
        cols[spec.out_key + "#set"] = snap_vk
        cols[spec.out_key + "#setm"] = snap_live
    ov = overflow.to(torch.int32)
    prev = cols.get("__agg_overflow__")
    cols["__agg_overflow__"] = ov if prev is None else torch.maximum(prev, ov)
    return cols


def apply_aggregators(specs: List[AggSpec], state: dict, cols: dict, ctx: dict,
                      num_keys: int) -> Tuple[dict, dict]:
    """Run all aggregator scans for one batch, updating ``state`` in place.

    Requires cols['__gk__'] (group ids; all-zero when no group-by). Adds
    per-spec output columns spec.out_key (+ '?' null masks) with the
    post-event running value for every row. Returns (state, cols)."""
    gk = cols["__gk__"].to(torch.int64)
    valid = cols[VALID_KEY]
    types = cols[TYPE_KEY]
    B = gk.shape[0]
    dev = gk.device
    K = num_keys

    participates = valid & ((types == CURRENT) | (types == EXPIRED))
    is_reset = valid & (types == RESET)
    epoch = torch.cumsum(is_reset.to(torch.int32), dim=0)  # epoch AFTER each row
    epoch_before = epoch - is_reset.to(torch.int32)        # resets strictly before
    final_epoch = epoch[B - 1]

    cols = dict(cols)
    for i, spec in enumerate(specs):
        if spec.kind in DISTINCT_KINDS:
            cols = _apply_distinct(spec, state[f"a{i}"], cols, ctx, K, gk,
                                   participates, epoch_before, final_epoch)
    scans = [(i, spec) for i, spec in enumerate(specs)
             if spec.kind not in DISTINCT_KINDS]
    if not scans:
        return state, cols
    any_reset = is_reset.any()

    # sort rows by group; pad/invalid rows and RESET rows (which act on ALL
    # groups through the epoch counter) go last (gk = K)
    sort_gk = torch.where(participates, gk, torch.full_like(gk, K))
    order = torch.argsort(sort_gk, stable=True)
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(B, dtype=torch.int64, device=dev)

    gk_sorted = sort_gk[order]
    epoch_sorted = epoch_before[order]

    first = torch.zeros(1, dtype=torch.bool, device=dev)
    last = torch.ones(1, dtype=torch.bool, device=dev)
    prev_same_group = torch.cat([first, gk_sorted[1:] == gk_sorted[:-1]])
    prev_same_epoch = torch.cat([first, epoch_sorted[1:] == epoch_sorted[:-1]])
    blocked = ~(prev_same_group & prev_same_epoch)        # segment starts
    live = gk_sorted < K
    # state folds in only at a group's first row in epoch 0
    fold_state = blocked & (epoch_sorted == 0) & live
    last_of_group = torch.cat([gk_sorted[1:] != gk_sorted[:-1], last])
    upd_mask = last_of_group & (epoch_sorted == final_epoch) & live
    safe_gk = torch.clamp(gk_sorted, max=K - 1)

    for i, spec in scans:
        st = state[f"a{i}"]                              # [slots, K]
        comb = _combine(spec.kind)
        deltas_sorted = _deltas(spec, cols, ctx)[:, order]
        folded = comb(st[:, safe_gk], deltas_sorted)
        vals = torch.where(fold_state[None, :], folded, deltas_sorted)
        scanned = _segmented_scan(comb, blocked, vals)    # [slots, B]
        out = scanned[:, inv_order]                       # original row order

        # persistent state: all-identity on any RESET, then last-row-per-
        # group values for groups active in the final epoch (in place)
        _reset_(st, spec.kind, any_reset)
        put_where_(st, 1, safe_gk, scanned, upd_mask)

        value, null_mask = _output(spec, [out[s] for s in range(spec.slots)])
        cols[spec.out_key] = value.to(T.torch_dtype_of(spec.out_type))
        if null_mask is not None:
            cols[spec.out_key + "?"] = null_mask
    return state, cols


def supported_aggregators() -> Tuple[str, ...]:
    return tuple(_AGG_DEFS)


def check_ported(kind: str) -> None:
    if kind not in _AGG_DEFS:
        raise CompileError(
            f"aggregator '{kind}()' is not ported to siddhi_tpu_torch yet "
            f"(ported: {', '.join(_AGG_DEFS)})")
