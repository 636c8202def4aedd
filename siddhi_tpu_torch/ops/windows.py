"""Window stages as ring-buffer tensor stages.

Counterpart of the parts of ``siddhi_tpu/ops/windows.py`` the port runs:
``WindowStage``, the sliding ``LengthWindowStage`` (a per-query window,
the one outside partitions), ``_order_emit``, ``_row_order_base``, the
row-type constants, the ring column specs and the ``create_window_stage``
factory. The other window kinds (time, batch, sort, ...) are not ported
yet and raise ``CompileError`` naming themselves.

A stage is ``apply(state, cols, ctx) -> (state, out_cols)``: ``state`` is
a dict of tensors the stage updates IN PLACE (see ``ops/scatter.py``),
``out_cols`` a fresh dict. Emission order is one stable sort by an order
key per emitted row, with invalid rows last.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.ops.expressions import (
    OKEY_KEY, RIDX_KEY, TS_KEY, TYPE_KEY, VALID_KEY, CompileError)
from siddhi_tpu_torch.ops.scatter import put_where_
from siddhi_tpu_torch.ops.types import to_torch_dtype
from siddhi_tpu_torch.query_api.execution import Window
from siddhi_tpu_torch.query_api.expressions import Constant, TimeConstant

CURRENT, EXPIRED, TIMER, RESET = 0, 1, 2, 3

_BIG = 2 ** 62


def _data_keys(cols: Dict) -> List[str]:
    """The columns a window buffers and emits (not types, validity or
    the routed order keys). The '#set'/'#setm' companions of multi-element
    sets never enter a window, as in the reference: only the base column
    is buffered, and a downstream unionSet that needs the elements raises."""
    return sorted(k for k in cols
                  if k not in (TYPE_KEY, VALID_KEY, RIDX_KEY, OKEY_KEY)
                  and "#set" not in k)


def _order_emit(parts) -> Tuple[Dict, torch.Tensor]:
    """Concatenate (data_cols, types, valid, order_key) groups and sort by
    order key with invalid rows last. Returns (out_cols, sorted_keys)."""
    keys = _data_keys(parts[0][0])
    data = {k: torch.cat([p[0][k] for p in parts]) for k in keys}
    types = torch.cat([p[1] for p in parts])
    valid = torch.cat([p[2] for p in parts])
    okey = torch.cat([p[3] for p in parts])
    okey = torch.where(valid, okey, torch.full_like(okey, _BIG))
    order = torch.argsort(okey, stable=True)
    out = {k: v[order] for k, v in data.items()}
    out[TYPE_KEY] = types[order]
    out[VALID_KEY] = valid[order]
    return out, okey[order]


def _insert_ranks(valid_cur):
    """(rank per valid row, total inserts) — rank = arrival index among
    the batch's CURRENT rows."""
    rank = torch.cumsum(valid_cur.to(torch.int64), dim=0) - 1
    return rank, valid_cur.sum(dtype=torch.int64)


def _row_order_base(cols: Dict, B: int, device):
    """Per-row base for emission order keys: the row's position in the
    ORIGINAL batch. Plain steps see ``arange(B)``; under device routing
    the route wrapper attaches ``RIDX_KEY`` (each row's index in the
    pre-exchange batch) so order keys compare ACROSS shards."""
    ridx = cols.get(RIDX_KEY)
    if ridx is not None:
        return ridx.to(torch.int64)
    return torch.arange(B, dtype=torch.int64, device=device)


class WindowStage:
    def init_state(self, num_keys: int, device) -> dict:
        raise NotImplementedError

    def conform(self, cols: Dict) -> Dict:
        """Cast batch columns to this stage's declared ring dtypes
        (hand-built batches often carry int64 id columns where the ring
        stores int32)."""
        specs = getattr(self, "col_specs", None)
        if not specs:
            return cols
        out = dict(cols)
        for k, dt in specs.items():
            v = out.get(k)
            tdt = to_torch_dtype(dt)
            if v is not None and v.dtype != tdt:
                out[k] = v.to(tdt)
        return out

    def apply(self, state: dict, cols: Dict, ctx: Dict):
        raise NotImplementedError


def conform_cols(stage, cols: Dict) -> Dict:
    """``stage.conform(cols)`` for any stage-like object: stages that take
    the window's place without subclassing WindowStage
    (``ops/fused_agg.FusedSlidingAggStage``) pass the columns through."""
    fn = getattr(stage, "conform", None)
    return fn(cols) if fn is not None else cols


class LengthWindowStage(WindowStage):
    """Sliding length window over the whole stream (reference
    ``LengthWindowProcessor.java:106-142``): once full, each arrival
    emits [EXPIRED(oldest, ts=now), CURRENT]. The ring is ``W`` slots per
    buffered column plus a 0-d int64 ``total`` of rows ever inserted,
    written in place."""

    def __init__(self, length: int, col_specs: Dict[str, np.dtype]):
        if length <= 0:
            raise CompileError("length window needs a positive length")
        self.length = length
        self.col_specs = col_specs

    def init_state(self, num_keys: int, device) -> dict:
        W = self.length
        buf = {k: torch.zeros((W,), dtype=to_torch_dtype(dt), device=device)
               for k, dt in self.col_specs.items()}
        return {"buf": buf,
                "total": torch.zeros((), dtype=torch.int64, device=device)}

    def apply(self, state, cols, ctx):
        W = self.length
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)

        total = state["total"]
        rank, n_ins = _insert_ranks(valid_cur)
        seq = total + rank        # per-window sequence of each inserted row

        # rank -> batch row, for evictees inserted earlier in this batch
        arange = torch.arange(B, dtype=torch.int64, device=dev)
        rank_to_row = torch.zeros((B,), dtype=torch.int64, device=dev)
        put_where_(rank_to_row, 0, rank, arange, valid_cur)

        evicts = valid_cur & (seq >= W)
        evict_seq = seq - W
        from_batch = evict_seq >= total
        ring_slot = evict_seq % W
        batch_row = rank_to_row[torch.clamp(evict_seq - total, 0, B - 1)]

        # read every evictee BEFORE the ring is written below
        expired = {}
        for k in keys:
            ring_v = state["buf"][k][ring_slot]
            expired[k] = torch.where(from_batch, cols[k][batch_row], ring_v)
        expired[TS_KEY] = torch.full((B,), int(ctx["current_time"]),
                                     dtype=torch.int64, device=dev)

        # write the last min(W, n_ins) inserted rows (unique slots)
        write = valid_cur & (rank >= n_ins - W)
        slot = seq % W
        for k, buf in state["buf"].items():
            put_where_(buf, 0, slot, cols[k], write)
        total.add_(n_ins)

        parts = [
            (expired, torch.full((B,), EXPIRED, dtype=torch.int8, device=dev),
             evicts, 2 * arange),
            ({k: cols[k] for k in keys}, cols[TYPE_KEY], valid_cur, 2 * arange + 1),
        ]
        out, _ = _order_emit(parts)
        return state, out


def window_col_specs(input_def, extra: Tuple[str, ...] = ()) -> Dict[str, np.dtype]:
    """Column dtypes a window ring buffer must carry for a stream: every
    attribute + its null mask, the timestamp, and reserved id columns."""
    from siddhi_tpu_torch.ops.types import dtype_of

    col_specs: Dict[str, np.dtype] = {}
    for a in input_def.attributes:
        col_specs[a.name] = dtype_of(a.type)
        col_specs[a.name + "?"] = np.bool_
    col_specs[TS_KEY] = np.int64
    col_specs["__gk__"] = np.int32
    for name in extra:
        col_specs[name] = np.int32
    return col_specs


def _const_param(window: Window, i: int, name: str):
    if i >= len(window.parameters):
        raise CompileError(f"{window.name} window missing parameter '{name}'")
    p = window.parameters[i]
    if isinstance(p, TimeConstant):
        return int(p.value)
    if isinstance(p, Constant):
        return p.value
    raise CompileError(f"{window.name} window parameter '{name}' must be a constant")


def _int_const_param(window: Window, i: int, name: str):
    """A parameter that must be an int/long constant (or time constant)."""
    v = _const_param(window, i, name)
    if isinstance(v, (float, str, bool)):
        raise CompileError(
            f"{window.name} window parameter '{name}' must be int or long, "
            f"found a {type(v).__name__} constant")
    return int(v)


def _expect_arity(window: Window, low: int, high: int):
    n = len(window.parameters)
    if not (low <= n <= high):
        want = str(low) if low == high else f"{low}..{high}"
        raise CompileError(
            f"{window.name} window expects {want} parameter(s), found {n}")


def create_window_stage(window: Window, input_def, resolver, app_context) -> WindowStage:
    """Window factory for unpartitioned streams: the length branch of the
    reference's ``create_window_stage``; other windows are not ported."""
    name = window.name.lower()
    if name == "length":
        _expect_arity(window, 1, 1)
        return LengthWindowStage(_int_const_param(window, 0, "length"),
                                 window_col_specs(input_def))
    raise CompileError(
        f"{window.name} window is not ported to siddhi_tpu_torch yet "
        f"(ported: length)")
