"""Fused sliding-window aggregation: window eviction folded into
invertible-aggregator deltas.

Counterpart of ``siddhi_tpu/ops/fused_agg.py`` (the same algorithm). The
generic pipeline materializes [EXPIRED(oldest), CURRENT] pairs per
arrival (2B rows) and runs the selector's segmented scans over all of
them (``ops/windows.py`` + ``ops/aggregators.py``). When the query only
consumes CURRENT outputs and every aggregator is invertible
(sum/count/avg/stdDev/and/or, all add-combine), the expired rows exist
only to feed negative deltas into the aggregators, so this stage skips
them:

- one output row per arriving CURRENT event, carrying the post-event
  running aggregate of its group (in exact mode the generic path's value
  for that CURRENT row, to float rounding);
- the ring stores each aggregator's delta tuple (not the raw attribute),
  so eviction is a gather and a negate;
- the per-group base is re-derived from the ring every step (one
  ``[W] -> [K+1]`` ``index_add_``), so no float accumulator persists to
  drift, and the state is just the ring;
- one sort of the interleaved (evict, insert) delta stream orders the
  segmented prefix sums; the rest is cumsum, gather and scatter.

Slot dtypes follow the app's precision: 64-bit under ``exact`` (the
port's default on every device; the H100 runs FP64 natively), 32-bit
floats under ``@app:precision('fast')``. The ring is written in place
(``ops/scatter.put_where_``) and no step reads a device value back.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from siddhi_tpu_torch.ops import aggregators as agg_ops
from siddhi_tpu_torch.ops import types as T
from siddhi_tpu_torch.ops.expressions import TYPE_KEY, VALID_KEY, CompileError
from siddhi_tpu_torch.ops.scatter import put_where_
from siddhi_tpu_torch.query_api.definitions import AttrType

CURRENT = 0
GK_KEY = "__gk__"

# aggregators whose EXPIRED contribution is a negated delta (add-combine)
INVERTIBLE = ("sum", "count", "avg", "stddev", "and", "or")


def fusable_specs(specs: List[agg_ops.AggSpec]) -> bool:
    return bool(specs) and all(s.kind in INVERTIBLE for s in specs)


def _spec_slot_names(i: int, spec: agg_ops.AggSpec) -> List[str]:
    return [f"s{i}_{j}" for j in range(spec.slots)]


class FusedSlidingAggStage:
    """``#window.length(W)`` (+ filters upstream) straight into invertible
    group-by aggregators. Takes the window stage's place in the query
    step; its output already carries the aggregate columns, so the
    selector runs in precomputed mode (projection and having only)."""

    def __init__(self, length: int, specs: List[agg_ops.AggSpec],
                 num_keys_ref, exact: bool):
        self.length = length
        self.specs = specs
        # the selector plan owns the padded key capacity (pow2 growth
        # rebuilds the step); read it on every apply
        self._num_keys_ref = num_keys_ref
        self.exact = exact
        self.fdtype = torch.float64 if exact else torch.float32

    @property
    def num_keys(self) -> int:
        return self._num_keys_ref()

    def _slot_dtypes(self) -> List[torch.dtype]:
        """Accumulation dtype per slot column. Exact mode matches the
        generic path's accumulators: int64 for count/and/or and integer
        sums (so long sums beyond 2^53 stay exact), float64 otherwise.
        Fast mode is float32 throughout."""
        out: List[torch.dtype] = []
        for spec in self.specs:
            if not self.exact:
                out.extend([torch.float32] * spec.slots)
                continue
            k = spec.kind
            if k in ("count", "and", "or"):
                out.append(torch.int64)
            elif k == "sum":
                val_dt = (torch.int64 if spec.arg_type in (AttrType.INT, AttrType.LONG)
                          else torch.float64)
                out.extend([val_dt, torch.int64])              # (sum, n)
            elif k == "avg":
                out.extend([torch.float64, torch.int64])
            else:  # stddev
                out.extend([torch.float64, torch.float64, torch.int64])
        return out

    def _slot_names(self) -> List[str]:
        return [n for i, s in enumerate(self.specs) for n in _spec_slot_names(i, s)]

    def init_state(self, num_keys: int, device) -> dict:
        W = self.length
        state = {n: torch.zeros((W,), dtype=dt, device=device)
                 for n, dt in zip(self._slot_names(), self._slot_dtypes())}
        state["rgk"] = torch.zeros((W,), dtype=torch.int32, device=device)
        state["fill"] = torch.zeros((), dtype=torch.int32, device=device)  # occupied slots (<= W)
        state["head"] = torch.zeros((), dtype=torch.int32, device=device)  # next write slot
        return state

    def _deltas(self, cols, ctx) -> List[torch.Tensor]:
        """Per-slot-column [B] delta tensors (0 for null or
        non-participating rows), in spec order. CURRENT sign; eviction
        negates."""
        xp = ctx["xp"]
        valid = cols[VALID_KEY] & (cols[TYPE_KEY] == CURRENT)
        B = valid.shape[0]
        parts: List[torch.Tensor] = []
        dtypes = self._slot_dtypes()
        one = torch.ones((), dtype=torch.float64, device=valid.device)

        def emit(ok, val):
            dt = dtypes[len(parts)]
            parts.append(torch.where(ok, val.to(dt), torch.zeros((), dtype=dt,
                                                                 device=valid.device)))

        for spec in self.specs:
            if spec.arg_fn is not None:
                v, null_mask = spec.arg_fn(cols, ctx)
                v = xp.asarray(v).expand(B)
                ok = valid if null_mask is None else (valid & ~null_mask)
            else:
                v, ok = None, valid
            k = spec.kind
            if k in ("sum", "avg"):
                emit(ok, v)
                emit(ok, one)                 # non-null count: empty -> null
            elif k == "count":
                emit(ok, one)
            elif k == "stddev":
                emit(ok, v)
                emit(ok, v.to(self.fdtype) * v.to(self.fdtype))
                emit(ok, one)
            elif k == "and":
                emit(ok & ~v.to(torch.bool), one)
            else:  # or
                emit(ok & v.to(torch.bool), one)
        return parts

    def apply(self, state: dict, cols: Dict, ctx: Dict):
        W = self.length
        K = self.num_keys
        valid_cur = cols[VALID_KEY] & (cols[TYPE_KEY] == CURRENT)
        B = valid_cur.shape[0]
        dev = valid_cur.device
        gk = cols[GK_KEY].to(torch.int32)

        slot_names = self._slot_names()
        rgk = state["rgk"]
        fill0 = state["fill"].clone()
        head0 = state["head"].clone()

        deltas = self._deltas(cols, ctx)                   # per column [B]

        # arrival ranks (int32: the stream position never enters the math)
        rank = torch.cumsum(valid_cur, dim=0, dtype=torch.int32) - 1
        n_ins = valid_cur.sum(dtype=torch.int32)

        # rank -> batch row (for same-batch evictions when n_ins > W)
        arange_b = torch.arange(B, dtype=torch.int32, device=dev)
        rank_to_row = torch.zeros((B,), dtype=torch.int32, device=dev)
        put_where_(rank_to_row, 0, rank, arange_b, valid_cur)

        # insert r evicts FIFO entry e = fill0 + r - W (>= 0); entries
        # 0..fill0-1 live in the ring starting at tail, >= fill0 are this
        # batch's own inserts
        evicts = valid_cur & (fill0 + rank >= W)
        e_idx = fill0 + rank - W
        from_batch = e_idx >= fill0
        tail = (head0 - fill0) % W
        ring_slot = ((tail + torch.clamp(e_idx, 0, W - 1)) % W).long()
        batch_row = rank_to_row[torch.clamp(e_idx - fill0, 0, B - 1).long()].long()

        evict_gk = torch.where(from_batch, gk[batch_row], rgk[ring_slot])

        # ---- interleaved delta stream: evict_i at 2i, insert_i at 2i+1
        d_gk = torch.stack([evict_gk, gk], dim=1).reshape(2 * B)
        d_live = torch.stack([evicts, valid_cur], dim=1).reshape(2 * B)

        # one sort keyed (group, position); the keys are unique. int64
        # always: the reference narrows to int32 when K*(2B+1) < 2^31,
        # which changes the key's width, not the order
        idx2b = torch.arange(2 * B, dtype=torch.int64, device=dev)
        key = (torch.where(d_live, d_gk, K).to(torch.int64) * (2 * B + 1)
               + idx2b)
        order = torch.argsort(key)
        gk_sorted = d_gk[order]
        seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                               gk_sorted[1:] != gk_sorted[:-1]])
        start_of = torch.cummax(
            torch.where(seg_start, idx2b, torch.zeros_like(idx2b)), dim=0).values
        occ = torch.arange(W, dtype=torch.int32, device=dev) < fill0
        base_idx = torch.where(occ, rgk, K).long()
        gk_clip = torch.clamp(gk_sorted, max=K).long()

        # per slot column (dtypes differ: int64 counts/int sums in exact
        # mode): interleave, permute, segmented prefix via cumsum, plus the
        # group's base re-derived from the pre-batch ring (exact: no
        # persistent accumulator to drift across batches)
        ins_running: List[torch.Tensor] = []
        for j, n in enumerate(slot_names):
            ring_col = state[n]
            d = deltas[j]
            ev = torch.where(from_batch, d[batch_row], ring_col[ring_slot])
            col = torch.stack([-ev, d], dim=1).reshape(2 * B)
            col = torch.where(d_live, col, torch.zeros_like(col))
            col_sorted = col[order]
            cs = torch.cumsum(col_sorted, dim=0)
            ex = cs - col_sorted
            running = cs - ex[start_of]
            base = torch.zeros((K + 1,), dtype=ring_col.dtype, device=dev).index_add_(
                0, base_idx, torch.where(occ, ring_col, torch.zeros_like(ring_col)))
            running = running + base[gk_clip]
            back = torch.empty_like(running)
            back[order] = running
            ins_running.append(back.reshape(B, 2)[:, 1])

        out = {k: cols[k] for k in cols if k != VALID_KEY}
        out[VALID_KEY] = valid_cur
        col_i = 0
        for spec in self.specs:
            slots = ins_running[col_i:col_i + spec.slots]
            col_i += spec.slots
            value, null_mask = agg_ops._output(spec, slots)
            out[spec.out_key] = value.to(T.torch_dtype_of(spec.out_type))
            if null_mask is not None:
                out[spec.out_key + "?"] = null_mask

        # ---- ring update, in place: write the last min(W, n_ins) inserts
        write = valid_cur & (rank >= n_ins - W)
        slot = (head0 + rank) % W
        for j, n in enumerate(slot_names):
            put_where_(state[n], 0, slot, deltas[j], write)
        put_where_(rgk, 0, slot, gk, write)
        state["fill"].copy_(torch.clamp(fill0 + n_ins, max=W))
        state["head"].copy_((head0 + n_ins) % W)
        return state, out

    def contents(self, state):
        raise CompileError(
            "a fused aggregation window cannot be probed as a join side")


def plan_fused_window(window_name: str, window_params, selector_plan,
                      app_context) -> Optional[FusedSlidingAggStage]:
    """A fused stage when the (window, selector) pair qualifies: sliding
    length window, every aggregator invertible, CURRENT-only output.
    Otherwise None (generic path)."""
    if window_name.lower() != "length":
        return None
    sel = selector_plan
    if sel.expired_on or not sel.current_on:
        return None
    if not fusable_specs(sel.specs):
        return None
    exact = getattr(app_context, "precision", "exact") == "exact"
    stage = FusedSlidingAggStage(
        int(window_params[0]), sel.specs, num_keys_ref=lambda: sel.num_keys,
        exact=exact)
    sel.precomputed = True
    return stage
