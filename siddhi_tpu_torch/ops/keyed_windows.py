"""Per-partition-key window stages: dense ``[K, W]`` ring buffers.

Counterpart of ``siddhi_tpu/ops/keyed_windows.py``, holding the length
window, the one this slice runs. All keys share one state tensor per
column: buffers are flat ``[K*W]`` tensors (key ``k`` owns slots
``[k*W, (k+1)*W)``), so key-capacity growth is a prefix copy and a batch
updates every key's window with one gather and one scatter.

Keyed length semantics (reference ``LengthWindowProcessor`` per key):
sliding; when key k's window is full, each arrival on k emits
[EXPIRED(oldest of k, ts=now), CURRENT].

The rings are written in place (``ops/scatter.put_where_``) where the
reference rebuilt them under a donated jit, so a step never copies the
``K*W``-row state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from siddhi_tpu_torch.ops.expressions import (
    OKEY_KEY, PK_KEY, RIDX_KEY, TS_KEY, TYPE_KEY, VALID_KEY, CompileError)
from siddhi_tpu_torch.ops.scatter import put_where_
from siddhi_tpu_torch.ops.types import to_torch_dtype
from siddhi_tpu_torch.ops.windows import (
    CURRENT,
    EXPIRED,
    WindowStage,
    _data_keys,
    _expect_arity,
    _int_const_param,
    _order_emit,
    _row_order_base,
    window_col_specs,
)


def _per_key_layout(pk, valid_cur, num_keys: int):
    """Group batch rows by key: returns (order, inv_order, occ, counts,
    start_pos) where occ[i] is row i's arrival rank within its key this
    batch, counts is [K] per-key insert count, and start_pos[i] is the
    sorted-array position of the first row of row i's key."""
    B = pk.shape[0]
    dev = pk.device
    safe_pk = torch.where(valid_cur, pk, torch.full_like(pk, num_keys))
    order = torch.argsort(safe_pk, stable=True)
    sidx = torch.arange(B, dtype=torch.int64, device=dev)
    inv_order = torch.empty_like(order)
    inv_order[order] = sidx
    pk_sorted = safe_pk[order]
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           pk_sorted[1:] != pk_sorted[:-1]])
    start_pos_sorted = torch.cummax(
        torch.where(seg_start, sidx, torch.full_like(sidx, -1)), dim=0).values
    occ_sorted = sidx - start_pos_sorted
    occ = occ_sorted[inv_order]
    start_pos = start_pos_sorted[inv_order]
    # index_add_, not bincount: bincount sizes its output from a host read
    counts = torch.zeros(num_keys + 1, dtype=torch.int64, device=dev).index_add_(
        0, safe_pk, torch.ones_like(safe_pk))[:num_keys]
    return order, inv_order, occ, counts, start_pos


class KeyedLengthWindowStage(WindowStage):
    """Sliding length window per partition key."""

    def __init__(self, length: int, col_specs: Dict[str, np.dtype]):
        if length <= 0:
            raise CompileError("length window needs a positive length")
        self.length = length
        self.col_specs = col_specs

    def init_state(self, num_keys: int, device) -> dict:
        W = self.length
        buf = {k: torch.zeros((num_keys * W,), dtype=to_torch_dtype(dt),
                              device=device)
               for k, dt in self.col_specs.items()}
        return {"buf": buf,
                "total": torch.zeros((num_keys,), dtype=torch.int64,
                                     device=device)}

    def apply(self, state, cols, ctx):
        W = self.length
        total = state["total"]
        K = total.shape[0]
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
        pk = torch.clamp(cols[PK_KEY].to(torch.int64), 0, K - 1)

        order, _inv, occ, counts, start_pos = _per_key_layout(pk, valid_cur, K)

        total0 = total[pk]                     # per-row prior count of its key
        seq = total0 + occ                     # per-key arrival sequence
        evicts = valid_cur & (seq >= W)
        evict_seq = seq - W

        # evictee inserted earlier in this same batch?
        from_batch = evict_seq >= total0
        batch_sorted_pos = torch.clamp(start_pos + (evict_seq - total0), 0, B - 1)
        batch_row = order[batch_sorted_pos]
        flat = torch.clamp(pk * W + evict_seq % W, 0, K * W - 1)

        # read every evictee BEFORE the ring is written below
        expired = {}
        for k in keys:
            ring_v = state["buf"][k][flat]
            expired[k] = torch.where(from_batch, cols[k][batch_row], ring_v)
        expired[TS_KEY] = torch.full((B,), int(ctx["current_time"]),
                                     dtype=torch.int64, device=dev)

        # write the last min(W, n_key) arrivals of each key (unique slots)
        write = valid_cur & (occ >= counts[pk] - W)
        slot = pk * W + seq % W
        for k, buf in state["buf"].items():
            put_where_(buf, 0, slot, cols[k], write)
        total.add_(counts)

        # order base: original batch position (global under device
        # routing, so a shard's 2*i/2*i+1 keys interleave with its peers')
        idx = _row_order_base(cols, B, dev)
        parts = [
            (expired, torch.full((B,), EXPIRED, dtype=torch.int8, device=dev),
             evicts, 2 * idx),
            ({k: cols[k] for k in keys}, cols[TYPE_KEY], valid_cur, 2 * idx + 1),
        ]
        out, okey = _order_emit(parts)
        if RIDX_KEY in cols:
            out[OKEY_KEY] = okey   # route wrapper merges shards by this
        return state, out


def create_keyed_window_stage(window, input_def, resolver, app_context) -> WindowStage:
    """Keyed (partitioned) window factory: the length branch of the
    reference factory; other keyed windows are not ported yet."""
    name = window.name.lower()
    col_specs = window_col_specs(input_def, extra=(PK_KEY,))
    if name == "length":
        _expect_arity(window, 1, 1)
        return KeyedLengthWindowStage(_int_const_param(window, 0, "length"), col_specs)
    raise CompileError(
        f"window '{window.name}' inside a partition is not ported to "
        f"siddhi_tpu_torch yet (ported: length)")
