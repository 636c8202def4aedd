"""Attribute aggregators as segmented prefix scans over dense keyed state.

Counterpart of ``siddhi_tpu/ops/aggregators.py`` for ``sum``, ``count``
and ``avg``, the invertible aggregators this slice runs; the others
(min/max, stdDev, distinctCount, ...) raise ``CompileError`` until a later
slice ports them.

Per aggregator the state is one ``[slots, K]`` tensor. One batch:
CURRENT rows add, EXPIRED rows subtract, RESET rows reset every group
(the reference's ``cleanGroupByStates``), and every row gets the running
value after it. Rows are sorted by (group, position); persistent state
folds into each group's first row of epoch 0; segment starts and in-batch
RESET epochs block the scan; the last row per group writes back.

The reference runs the segmented combine with ``lax.associative_scan``.
Torch has no associative scan, so ``_segmented_scan`` is a log-step
(Hillis-Steele) scan: ceil(log2 B) passes of elementwise torch ops. It
adds in another order than the reference, so float sums agree to
rounding, not bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from siddhi_tpu_torch.ops import types as T
from siddhi_tpu_torch.ops.expressions import TYPE_KEY, VALID_KEY, CompileError
from siddhi_tpu_torch.ops.scatter import put_where_
from siddhi_tpu_torch.query_api.definitions import AttrType

CURRENT, EXPIRED, TIMER, RESET = 0, 1, 2, 3

# every ported aggregator combines by addition; its fold identity is 0
_SLOTS = {"sum": 2, "count": 1, "avg": 2}


@dataclass
class AggSpec:
    """One aggregator call site in the selection list."""

    kind: str                      # 'sum' | 'count' | 'avg'
    arg_fn: Optional[Callable]     # compiled arg fn(cols, ctx) -> (v, mask); None for count()
    arg_type: Optional[AttrType]
    out_key: str                   # synthetic output column name (__agg<i>__)
    out_type: AttrType = AttrType.DOUBLE

    @property
    def slots(self) -> int:
        return _SLOTS[self.kind]


def agg_result_type(kind: str, arg_type: Optional[AttrType]) -> AttrType:
    """sum: LONG for int/long input, DOUBLE otherwise; count: LONG;
    avg: DOUBLE (reference aggregator executors)."""
    if kind == "count":
        return AttrType.LONG
    if kind == "avg":
        return AttrType.DOUBLE
    if kind == "sum":
        if arg_type in (AttrType.INT, AttrType.LONG):
            return AttrType.LONG
        return AttrType.DOUBLE
    raise CompileError(f"aggregator '{kind}' is not ported to siddhi_tpu_torch yet")


def _slot_dtype(spec: AggSpec) -> torch.dtype:
    """Accumulation dtype: Java accumulates in long/double."""
    if spec.kind == "count":
        return torch.int64
    if spec.kind == "sum" and spec.arg_type in (AttrType.INT, AttrType.LONG):
        return torch.int64
    return torch.float64


def init_agg_state(specs: List[AggSpec], num_keys: int, device) -> dict:
    """State dict: per spec a [slots, K] tensor at the fold identity 0."""
    return {f"a{i}": torch.zeros((spec.slots, num_keys), dtype=_slot_dtype(spec),
                                 device=device)
            for i, spec in enumerate(specs)}


def _deltas(spec: AggSpec, cols, ctx):
    """Per-event delta tuple [slots, B]; non-participating rows (invalid,
    TIMER, RESET, null argument) contribute 0."""
    types = cols[TYPE_KEY]
    valid = cols[VALID_KEY]
    is_cur = valid & (types == CURRENT)
    is_exp = valid & (types == EXPIRED)
    dtype = _slot_dtype(spec)
    v = None
    if spec.arg_fn is not None:
        v, null_mask = spec.arg_fn(cols, ctx)
        v = ctx["xp"].asarray(v).to(dtype).expand(types.shape)
        if null_mask is not None:
            # null arguments leave the state untouched
            is_cur = is_cur & ~null_mask
            is_exp = is_exp & ~null_mask
    sgn = is_cur.to(dtype) - is_exp.to(dtype)
    if spec.kind == "count":
        return sgn[None, :]
    if spec.kind == "avg":
        return torch.stack([sgn * v, sgn])           # (sum, count)
    zero = torch.zeros_like(v)
    d = torch.where(is_cur, v, torch.where(is_exp, -v, zero))
    return torch.stack([d, sgn])                     # (sum, non-null count)


def _output(spec: AggSpec, slots):
    """Running value -> (value, null_mask) per the reference return rules."""
    if spec.kind == "sum":
        return slots[0], slots[1] == 0   # null until a non-null folds in
    if spec.kind == "count":
        return slots[0], None
    s, c = slots[0], slots[1]
    empty = c == 0
    return s / torch.where(empty, torch.ones_like(c), c), empty


def _segmented_scan(blocked, vals):
    """Inclusive segmented sum along the last axis: ``out[:, i]`` is the
    sum of ``vals[:, j..i]`` where j is the last blocked position <= i.
    Hillis-Steele: pass d combines each element with the one d to its left
    (the reference's op: (fa, va) . (fb, vb) = (fa | fb, vb if fb else
    va + vb))."""
    B = vals.shape[-1]
    f, v = blocked, vals
    d = 1
    while d < B:
        v_new = v[:, d:] + torch.where(f[d:], torch.zeros_like(v[:, d:]), v[:, :-d])
        f_new = f[d:] | f[:-d]
        v = torch.cat([v[:, :d], v_new], dim=1)
        f = torch.cat([f[:d], f_new])
        d *= 2
    return v


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
    any_reset = is_reset.any()

    # sort rows by group; pad/invalid rows and RESET rows (which act on ALL
    # groups through the epoch counter) go last (gk = K)
    sort_gk = torch.where(participates, gk, torch.full_like(gk, K))
    order = torch.argsort(sort_gk, stable=True)
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(B, dtype=torch.int64, device=dev)

    gk_sorted = sort_gk[order]
    epoch = torch.cumsum(is_reset.to(torch.int32), dim=0)  # epoch AFTER each row
    epoch_before = epoch - is_reset.to(torch.int32)        # resets strictly before
    epoch_sorted = epoch_before[order]
    final_epoch = epoch[B - 1]

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

    cols = dict(cols)
    for i, spec in enumerate(specs):
        st = state[f"a{i}"]                              # [slots, K]
        deltas_sorted = _deltas(spec, cols, ctx)[:, order]
        folded = st[:, safe_gk] + deltas_sorted
        vals = torch.where(fold_state[None, :], folded, deltas_sorted)
        scanned = _segmented_scan(blocked, vals)          # [slots, B]
        out = scanned[:, inv_order]                       # original row order

        # persistent state: all-identity on any RESET, then last-row-per-
        # group values for groups active in the final epoch (in place)
        st.masked_fill_(any_reset, 0)
        put_where_(st, 1, safe_gk, scanned, upd_mask)

        value, null_mask = _output(spec, [out[s] for s in range(spec.slots)])
        cols[spec.out_key] = value.to(T.torch_dtype_of(spec.out_type))
        if null_mask is not None:
            cols[spec.out_key + "?"] = null_mask
    return state, cols


def check_ported(kind: str) -> None:
    if kind not in _SLOTS:
        raise CompileError(
            f"aggregator '{kind}()' is not ported to siddhi_tpu_torch yet "
            f"(ported: {', '.join(_SLOTS)})")

