"""Window stage base and the emission-order helpers shared by windows.

Counterpart of the parts of ``siddhi_tpu/ops/windows.py`` this slice
runs: ``WindowStage``, ``_order_emit``, ``_row_order_base``, the row-type
constants and the ring column specs. The other window kinds (time, batch,
sort, ...) are not ported yet.

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
from siddhi_tpu_torch.ops.types import to_torch_dtype
from siddhi_tpu_torch.query_api.execution import Window
from siddhi_tpu_torch.query_api.expressions import Constant, TimeConstant

CURRENT, EXPIRED, TIMER, RESET = 0, 1, 2, 3

_BIG = 2 ** 62


def _data_keys(cols: Dict) -> List[str]:
    """The columns a window buffers and emits (not types, validity or
    the routed order keys)."""
    return sorted(k for k in cols
                  if k not in (TYPE_KEY, VALID_KEY, RIDX_KEY, OKEY_KEY))


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
