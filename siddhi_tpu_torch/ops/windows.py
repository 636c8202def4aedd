"""Window stages as ring-buffer tensor stages.

Counterpart of ``siddhi_tpu/ops/windows.py`` for unpartitioned streams:
the sliding ``length``, ``time`` and ``externalTime`` windows, the
tumbling ``lengthBatch``, ``timeBatch``, ``batch`` and
``externalTimeBatch`` windows, ``hopping``, ``timeLength`` and ``delay``,
with ``_order_emit``, ``_row_order_base``, the row-type constants, the
ring column specs and the ``create_window_stage`` factory (which hands
sort/frequent/lossyFrequent/session/cron/expression/expressionBatch to
``ops/host_windows.py``), and ``PassthroughWindowStage``, a windowless
join side. Every stage's ``contents(state)`` is the ``(cols [W], valid
[W])`` view of its held rows that a join side probes.

A stage is ``apply(state, cols, ctx) -> (state, out_cols)``: ``state`` is
a dict of tensors the stage updates in place (rings through
``ops/scatter.put_where_``, scalars with ``copy_``; the batch windows'
buffers are replaced inside the same dict), ``out_cols`` a fresh dict.
Emission order is one stable sort by an order key per emitted row, with
invalid rows last. Stages that need timers put ``__notify__`` (the next
wanted wake time, -1 if none) in ``out_cols``; bounded rings put
``__overflow__`` there, so the host raises instead of dropping rows.

The order key scheme of the sliding time windows, with STRIDE = Wc + B + 4:
  ring-expired item j  (drains before row r): key r*STRIDE + j
  in-batch expired of row i (before row r):   key r*STRIDE + Wc + i
  current row i:                              key i*STRIDE + Wc + B + 2
so expired rows precede the current row they drain before, FIFO among
themselves, exactly as ``insertBeforeCurrent`` produces. Keys are int64:
at Wc = 2^21 and B = 2^16 they reach about 1.4e11. Where the reference
emits all Wc ring items (most of them invalid), the port emits the FIFO
items up to the last expiring one, sized by one host read per step: the
same valid rows in the same order, without walking an all-but-empty
2^21-row emission at every step (a timer step expires one millisecond of
rows).

externalTime computes, without a ``[Wc, B]`` or ``[B, B]`` mask, the first
row whose cutoff covers each ring item (a ``searchsorted`` over the
running maximum of the clock) and each row's first later covering row (a
sparse table of range maxima with a binary-lifting descent, exact for a
clock that is not monotone): O((Wc + B) log B) memory.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.ops.expressions import (
    OKEY_KEY, RIDX_KEY, TS_KEY, TYPE_KEY, VALID_KEY, CompileError)
from siddhi_tpu_torch.ops.scatter import put_where_
from siddhi_tpu_torch.ops.types import to_torch_dtype
from siddhi_tpu_torch.query_api.definitions import AttrType
from siddhi_tpu_torch.query_api.execution import Window
from siddhi_tpu_torch.query_api.expressions import Constant, TimeConstant

CURRENT, EXPIRED, TIMER, RESET = 0, 1, 2, 3
NOTIFY_KEY = "__notify__"
OVERFLOW_KEY = "__overflow__"
FLUSH_KEY = "__flush__"
CHUNK_KEY = "__chunk__"   # a swept TIMER step's chain step of each row

_BIG = 2 ** 62


def _data_keys(cols: Dict) -> List[str]:
    """The columns a window buffers and emits (not types, validity or
    the routed order keys). The '#set'/'#setm' companions of multi-element
    sets never enter a window, as in the reference: only the base column
    is buffered, and a downstream unionSet that needs the elements raises."""
    return sorted(k for k in cols
                  if k not in (TYPE_KEY, VALID_KEY, NOTIFY_KEY, OVERFLOW_KEY,
                               FLUSH_KEY, CHUNK_KEY, RIDX_KEY, OKEY_KEY)
                  and "#set" not in k)


def _zero_rows(cols: Dict, n: int, device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((n,), dtype=cols[k].dtype, device=device)
            for k in _data_keys(cols)}


def _full(n, value, dtype, device) -> torch.Tensor:
    """A constant column (``value`` a Python scalar or a 0-d tensor)."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype).reshape(1).expand(n)
    return torch.full((n,), value, dtype=dtype, device=device)


def _scalar(value, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.int64, device=device)


def _flush_ids(okeys: torch.Tensor, span) -> torch.Tensor:
    """Flush epoch of each emitted row (its order key's span), 0 for the
    invalid rows sorted last."""
    return torch.where(okeys == _BIG, torch.zeros_like(okeys),
                       torch.div(okeys, span, rounding_mode="floor")).to(torch.int32)


def _scatter(base: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].set(src, mode="drop")`` on a copy: rows not kept or
    outside ``base`` are dropped."""
    out = base.clone()
    keep = keep & (idx >= 0) & (idx < base.shape[0])
    put_where_(out, 0, idx.to(torch.int64), src, keep)
    return out


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


def _mask_positions(mask, n: int):
    """Flat positions of the ``n`` set entries of ``mask`` in order (a
    compaction sized by the caller's host read: no sync of its own)."""
    flat = mask.reshape(-1)
    dev = flat.device
    rank = torch.cumsum(flat.to(torch.int64), 0) - 1
    tgt = torch.where(flat, rank, torch.full_like(rank, n))
    pos = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    pos.scatter_(0, tgt, torch.arange(flat.shape[0], dtype=torch.int64, device=dev))
    return pos[:n]


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
    # restored state re-arms its expiry timer (core/util/snapshot.py)
    needs_scheduler = False
    # True: ``apply`` makes no host read and takes ``ctx["current_time"]``
    # as a tensor too, so a fused fan-out step may hold it inside a CUDA
    # graph (core/query/step_graph.py). Undeclared stages are not.
    capturable = False

    batch_mode = False

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

    def contents(self, state: dict):
        """(cols [W], valid [W]) view of the held events: the probe surface
        of a join side (the role of FindableProcessor.find on window
        processors, reference ``JoinProcessor.java:134-147``)."""
        raise CompileError(
            f"{type(self).__name__} cannot be probed (used as a join side)")


def conform_cols(stage, cols: Dict) -> Dict:
    """``stage.conform(cols)`` for any stage-like object: stages that take
    the window's place without subclassing WindowStage
    (``ops/fused_agg.FusedSlidingAggStage``) pass the columns through."""
    fn = getattr(stage, "conform", None)
    return fn(cols) if fn is not None else cols


class PassthroughWindowStage(WindowStage):
    """A join side that retains nothing itself: a bare (window-less) stream
    side (reference ``EmptyWindowProcessor``; CURRENT only), or a named
    window's emission stream (``pass_expired=True``: the shared window
    already emitted typed CURRENT/EXPIRED events).

    ``empty_window`` is EmptyWindowProcessor.java:84: every arriving event
    becomes [CURRENT, EXPIRED(clone, ts=now) when the output expects
    expireds, RESET], so per-trigger aggregates of a windowless join
    restart per event; ``emit_reset=False`` leaves the RESET rows out
    where the query has no aggregate state to restart."""

    capturable = True

    def __init__(self, col_specs: Dict[str, np.dtype], pass_expired: bool = False,
                 empty_window: bool = False, expired_needed: bool = False,
                 emit_reset: bool = True):
        self.col_specs = col_specs
        self.pass_expired = pass_expired
        self.empty_window = empty_window
        self.expired_needed = expired_needed
        self.emit_reset = emit_reset

    def init_state(self, num_keys: int, device) -> dict:
        return {"empty": torch.zeros((1,), dtype=torch.int32, device=device)}

    def apply(self, state, cols, ctx):
        valid = cols[VALID_KEY]
        dev = valid.device
        if self.empty_window:
            keys = _data_keys(cols)
            B = valid.shape[0]
            # the clock as a column: a Python int, or a 0-d tensor inside a
            # captured step
            now = _full(B, ctx["current_time"], torch.int64, dev)
            valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
            rank, _n = _insert_ranks(valid_cur)
            parts = [({k: cols[k] for k in keys},
                      _full(B, CURRENT, torch.int8, dev), valid_cur, rank * 3)]
            if self.expired_needed:
                exp = {k: cols[k] for k in keys}
                exp[TS_KEY] = torch.where(valid_cur, now, cols[TS_KEY])
                parts.append((exp, _full(B, EXPIRED, torch.int8, dev),
                              valid_cur, rank * 3 + 1))
            if self.emit_reset:
                reset_rows = _zero_rows(cols, B, dev)
                reset_rows[TS_KEY] = torch.where(
                    valid_cur, now, torch.zeros_like(cols[TS_KEY]))
                parts.append((reset_rows, _full(B, RESET, torch.int8, dev),
                              valid_cur, rank * 3 + 2))
            out, _ = _order_emit(parts)
            return state, out
        out = {k: cols[k] for k in _data_keys(cols)}
        out[TYPE_KEY] = cols[TYPE_KEY]
        live = cols[TYPE_KEY] == CURRENT
        if self.pass_expired:
            live = live | (cols[TYPE_KEY] == EXPIRED)
        out[VALID_KEY] = valid & live
        return state, out

    def contents(self, state):
        dev = state["empty"].device
        cols = {k: torch.zeros((1,), dtype=to_torch_dtype(dt), device=dev)
                for k, dt in self.col_specs.items()}
        return cols, torch.zeros((1,), dtype=torch.bool, device=dev)


class LengthWindowStage(WindowStage):
    """Sliding length window over the whole stream (reference
    ``LengthWindowProcessor.java:106-142``): once full, each arrival
    emits [EXPIRED(oldest, ts=now), CURRENT]. The ring is ``W`` slots per
    buffered column plus a 0-d int64 ``total`` of rows ever inserted,
    written in place."""

    capturable = True

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

    @property
    def ring_capacity(self) -> int:
        return self.length

    def live_fill(self, state) -> torch.Tensor:
        """Live rows in the ring (a 0-d device tensor): the ``win_fill``
        instrument slot (``observability/instruments.py``), computed inside
        the step from the state it holds."""
        return torch.clamp(state["total"], max=self.length)

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
        # EXPIRED rows are stamped with the clock, which a captured step
        # takes as a 0-d tensor (a Python int would be baked in)
        expired[TS_KEY] = _full(B, ctx["current_time"], torch.int64, dev)

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

    def contents(self, state):
        """Join probe surface: (cols [W], valid [W]) of the held rows."""
        W = self.length
        j = torch.arange(W, dtype=torch.int64, device=state["total"].device)
        return dict(state["buf"]), j < torch.clamp(state["total"], max=W)


# -------------------------------------------------------------------- time

class TimeWindowStage(WindowStage):
    """Sliding time window (``TimeWindowProcessor.java:133-168``): expired
    rows drain before each event with ts set to now; TIMER chunks sweep;
    notify at the oldest live row's ts + t. ``external=True`` is
    externalTime: the cutoff advances with each event's clock attribute
    ``ts_key``, expired rows keep their timestamps, and no timer is
    needed. The ring is ``capacity`` slots per buffered column plus 0-d
    int64 ``total`` (rows ever inserted) and ``expired_upto`` (rows ever
    expired); rows expire as a FIFO prefix. A step emits the ring's FIFO
    items up to the last expiring one (a host read sizes it), the batch's
    expired clones and its current rows.

    The time window also keeps ``mono``, whether the live rows'
    timestamps are non-decreasing in FIFO order (so in playback and in
    live mode unless an event arrives late). While it holds, the expiring
    rows are a prefix found by a binary search and the next wake time is
    the oldest live row's, so a step reads O(log Wc + J + B) ring entries
    instead of all Wc; otherwise it scans the whole ring, as the
    reference does. Both give the reference's rows. While it holds, a
    TIMER step given ``ctx["horizon"]`` stands for the chain of timers up
    to it: the rows with ts + t <= horizon expire, each stamped
    max(now, ts + t), the time its own timer would have fired."""

    # not capturable: the step reads the clock and the emission's length
    # J on the host (and the scheduled form the FIFO's fill and head)
    capturable = False

    def __init__(self, time_ms: int, col_specs: Dict[str, np.dtype], capacity: int,
                 external: bool = False, ts_key: str = TS_KEY):
        self.time_ms = time_ms
        self.capacity = capacity
        self.col_specs = col_specs
        self.external = external
        self.needs_scheduler = not external
        self.ts_key = ts_key

    def init_state(self, num_keys: int, device) -> dict:
        Wc = self.capacity
        buf = {k: torch.zeros((Wc,), dtype=to_torch_dtype(dt), device=device)
               for k, dt in self.col_specs.items()}
        state = {"buf": buf,
                 "total": torch.zeros((), dtype=torch.int64, device=device),
                 "expired_upto": torch.zeros((), dtype=torch.int64, device=device)}
        if not self.external:
            state["mono"] = torch.ones((), dtype=torch.bool, device=device)
        return state

    @property
    def ring_capacity(self) -> int:
        return self.capacity

    def live_fill(self, state) -> torch.Tensor:
        """Live (unexpired) rows in the ring: the ``win_fill`` instrument
        slot; near ``capacity`` the ring is one skewed batch from
        overflow."""
        return torch.clamp(state["total"] - state["expired_upto"], min=0)

    def apply(self, state, cols, ctx):
        Wc = self.capacity
        t = self.time_ms
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
        ts = cols[TS_KEY]
        now = int(ctx["current_time"])
        STRIDE = Wc + B + 4
        buf = state["buf"]
        total0 = state["total"].clone()
        exp0 = state["expired_upto"].clone()

        # the ring's part of the emission is the FIFO items [0, J), J one
        # past the last expiring item, read back to size it: the reference
        # emits all Wc items, the rest invalid, which the emission sort and
        # the selector (a distinct scan's chain included) would then walk
        # at every step, timer steps too. The valid rows and their order
        # are the reference's. FIFO item j holds sequence exp0 + j.
        mono = False
        if self.external:
            ck = cols[self.ts_key]
            run_max = torch.cummax(
                torch.where(valid_cur, ck, torch.full_like(ck, -_BIG)), 0).values
            cutoff = run_max[B - 1] - t
        else:
            live0, head, mono = (int(x) for x in torch.stack([
                total0 - exp0, exp0 % Wc, state["mono"].to(torch.int64)]).tolist())
        # a TIMER step may sweep its chain of timers up to ``horizon``:
        # each row then expires at its own chain time, max(now, ts + t)
        horizon = ctx.get("horizon") if mono else None
        if mono:
            # a non-decreasing FIFO: the rows with ts <= now - t are a
            # prefix, found in its two contiguous ring segments
            n1 = min(live0, Wc - head)
            key = torch.full((1,), (now if horizon is None else horizon) - t,
                             dtype=torch.int64, device=dev)
            c1, c2 = torch.cat([
                torch.searchsorted(buf[TS_KEY][head:head + n1], key, right=True),
                torch.searchsorted(buf[TS_KEY][:live0 - n1], key, right=True),
            ]).tolist()
            J = c1 if c1 < n1 else n1 + c2
            j = torch.arange(J, dtype=torch.int64, device=dev)
            fifo_slot = (exp0 + j) % Wc
            expire_ring = torch.ones((J,), dtype=torch.bool, device=dev)
            n_exp_ring = _scalar(J, dev)
        else:
            j = torch.arange(Wc, dtype=torch.int64, device=dev)
            fifo_seq = exp0 + j
            fifo_slot = fifo_seq % Wc
            key_col = buf[self.ts_key if self.external else TS_KEY][fifo_slot]
            expire_ring = (fifo_seq < total0) & (
                key_col <= cutoff if self.external else key_col + t <= now)
            n_exp_ring = expire_ring.sum(dtype=torch.int64)
            # one explicit device-to-host read sizes the expired prefix
            J = torch.where(expire_ring, j + 1, 0).max().tolist()
            j, fifo_slot, expire_ring = j[:J], fifo_slot[:J], expire_ring[:J]
        # every ring read happens before the ring is written below
        ring_rows = {k: v[fifo_slot] for k, v in buf.items()}
        ring_ts = ring_rows[TS_KEY]

        if self.external:
            ring_ck = ring_rows[self.ts_key]
            # the first row whose cutoff covers item j: run_max is
            # non-decreasing, so it is the first r with run_max[r] >=
            # ring_ck + t (0 where none does, as the reference's argmax)
            first_row = torch.searchsorted(run_max, ring_ck + t)
            first_row = torch.where(first_row < B, first_row,
                                    torch.zeros_like(first_row))
            exp_ts_ring = ring_ts      # externalTime keeps the timestamps
            nxt = _first_later_covering(ck, valid_cur, t)
            batch_exp = valid_cur & (nxt < B)
            exp_ts_batch = ts
        else:
            first_row = torch.zeros((J,), dtype=torch.int64, device=dev)
            exp_ts_ring = (_full(J, now, torch.int64, dev) if horizon is None
                           else torch.clamp(ring_ts + t, min=now))
            nxt = _next_valid_index(valid_cur)
            batch_exp = valid_cur & (ts + t <= now) & (nxt < B)
            exp_ts_batch = _full(B, now, torch.int64, dev)

        idx = torch.arange(B, dtype=torch.int64, device=dev)
        ring_rows[TS_KEY] = torch.where(expire_ring, exp_ts_ring, ring_ts)
        batch_exp_rows = {k: cols[k] for k in keys}
        batch_exp_rows[TS_KEY] = exp_ts_batch
        parts = [
            (ring_rows, _full(J, EXPIRED, torch.int8, dev), expire_ring,
             first_row * STRIDE + j),
            (batch_exp_rows, _full(B, EXPIRED, torch.int8, dev), batch_exp,
             nxt * STRIDE + Wc + idx),
            ({k: cols[k] for k in keys}, cols[TYPE_KEY], valid_cur,
             idx * STRIDE + Wc + B + 2),
        ]
        out, _ = _order_emit(parts)

        # ring update: append the inserted rows, advance the expired prefix
        rank, n_ins = _insert_ranks(valid_cur)
        seq = total0 + rank
        write = valid_cur & (rank >= n_ins - Wc)
        if not self.external:
            # the FIFO stays non-decreasing when the inserted rows are, and
            # start no earlier than the last row already held (read before
            # the write)
            prev_max = torch.cummax(torch.where(valid_cur, ts, -_BIG), 0).values
            batch_ok = ~(valid_cur[1:] & (ts[1:] < prev_max[:-1])).any()
            first_ins = torch.where(valid_cur, ts, _BIG).min()
            last_old = buf[TS_KEY][(total0 - 1) % Wc]
            join_ok = (total0 == exp0) | (n_ins == 0) | (first_ins >= last_old)
        for k, b in buf.items():
            put_where_(b, 0, seq % Wc, cols[k], write)
        new_total = total0 + n_ins
        new_exp = exp0 + n_exp_ring + batch_exp.sum(dtype=torch.int64)
        out[OVERFLOW_KEY] = (new_total - new_exp > Wc).to(torch.int32)
        if self.external:
            out[NOTIFY_KEY] = _scalar(-1, dev)
        else:
            if mono:
                # the oldest live row held before the batch comes first;
                # the inserted rows may come in any order
                oldest = torch.where(new_exp < total0, buf[TS_KEY][new_exp % Wc], _BIG)
                ins_min = torch.where(write & (seq >= new_exp), ts, _BIG).min()
                nxt_notify = torch.minimum(oldest, ins_min) + t
            else:
                fifo2 = new_exp + torch.arange(Wc, dtype=torch.int64, device=dev)
                occ2 = fifo2 < new_total
                ts2 = buf[TS_KEY][fifo2 % Wc]
                nxt_notify = torch.where(occ2, ts2 + t, _BIG).min()
            out[NOTIFY_KEY] = torch.where(new_total > new_exp, nxt_notify, -1)
            state["mono"] = (new_total == new_exp) | (
                state["mono"] & batch_ok & join_ok)
        state["total"].copy_(new_total)
        state["expired_upto"].copy_(new_exp)
        return state, out

    def contents(self, state):
        """Join probe surface: slot j holds the newest sequence s < total
        with s % Wc == j, live when s >= expired_upto."""
        Wc = self.capacity
        total = state["total"]
        j = torch.arange(Wc, dtype=torch.int64, device=total.device)
        s_j = total - 1 - torch.remainder(total - 1 - j, Wc)
        valid = (total > 0) & (s_j >= 0) & (s_j >= state["expired_upto"])
        return dict(state["buf"]), valid


def _next_valid_index(valid):
    """For each i: the smallest valid index j > i (B if none)."""
    B = valid.shape[0]
    idx = torch.where(valid, torch.arange(B, dtype=torch.int64, device=valid.device),
                      2 * B)
    suffix_min = torch.flip(torch.cummin(torch.flip(idx, [0]), 0).values, [0])
    nxt = torch.cat([suffix_min[1:], suffix_min.new_full((1,), 2 * B)])
    return torch.clamp(nxt, max=B)


def _first_later_covering(ts, valid, t):
    """First valid row j > i with ts_j >= ts_i + t (B if none), for a
    clock that need not be monotone, in O(B log B) memory: a sparse table
    of range maxima over the valid rows' clocks, and for every row a
    descent that skips each power-of-two block lying wholly below its
    target. The blocks skipped hold no covering row, so the descent stops
    at the first one (or at B)."""
    B = ts.shape[0]
    dev = ts.device
    v = torch.where(valid, ts, torch.full_like(ts, -_BIG))
    # table[k][p] = max(v[p : p + 2^k]); positions past B - 2^k are never read
    table = [v]
    k = 1
    while (1 << k) <= B:
        prev = table[-1]
        half = 1 << (k - 1)
        nxt = prev.clone()
        nxt[: B - half] = torch.maximum(prev[: B - half], prev[half:])
        table.append(nxt)
        k += 1
    target = ts + t
    pos = torch.arange(1, B + 1, dtype=torch.int64, device=dev)
    for k in range(len(table) - 1, -1, -1):
        size = 1 << k
        fits = pos + size <= B
        blk = table[k][torch.clamp(pos, max=B - size)]
        pos = torch.where(fits & (blk < target), pos + size, pos)
    return pos


# ------------------------------------------------------------- lengthBatch

class LengthBatchWindowStage(WindowStage):
    """Tumbling count window; flushes exactly at count boundaries, possibly
    several times within one batch. Each flush emits [EXPIRED(previous
    flush, ts=now), RESET, CURRENT rows] (``LengthBatchWindowProcessor.
    java:153-260``). ``stream_current`` is the streamCurrentEvents
    overload: every arrival passes as CURRENT at once, and when the
    (W+1)-th event of a cycle arrives, [EXPIRED(previous W events,
    ts=now), RESET] come just before it."""

    batch_mode = True

    def __init__(self, length: int, col_specs: Dict[str, np.dtype],
                 expired_needed: bool = True, stream_current: bool = False):
        if length < 0:
            raise CompileError("lengthBatch window needs a non-negative length")
        self.length = length
        self.col_specs = col_specs
        self.expired_needed = expired_needed
        self.stream_current = stream_current

    def init_state(self, num_keys: int, device) -> dict:
        W = self.length

        def zero():
            return {k: torch.zeros((W,), dtype=to_torch_dtype(dt), device=device)
                    for k, dt in self.col_specs.items()}

        return {"cur": zero(), "prev": zero(),
                "count": torch.zeros((), dtype=torch.int64, device=device),
                "prev_count": torch.zeros((), dtype=torch.int64, device=device)}

    def _apply_zero(self, state, cols, ctx):
        """length 0: every arrival is its own instant batch, [CURRENT,
        EXPIRED(clone, ts=now), RESET] per event
        (``LengthBatchWindowProcessor.processLengthZeroBatch``)."""
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
        rank, _n = _insert_ranks(valid_cur)
        parts = [({k: cols[k] for k in keys}, _full(B, CURRENT, torch.int8, dev),
                  valid_cur, rank * 3)]
        if self.expired_needed:
            exp = {k: cols[k] for k in keys}
            exp[TS_KEY] = torch.where(valid_cur, now, cols[TS_KEY])
            parts.append((exp, _full(B, EXPIRED, torch.int8, dev), valid_cur,
                          rank * 3 + 1))
        reset_rows = _zero_rows(cols, B, dev)
        reset_rows[TS_KEY] = torch.where(valid_cur, now, 0)
        parts.append((reset_rows, _full(B, RESET, torch.int8, dev), valid_cur,
                      rank * 3 + 2))
        out, okeys = _order_emit(parts)
        out[FLUSH_KEY] = _flush_ids(okeys, 3)
        return state, out

    def _apply_stream(self, state, cols, ctx):
        """streamCurrentEvents mode: CURRENT rows pass at arrival; each
        cycle boundary (an arrival at seq = 0 mod W, seq > 0) first emits
        [EXPIRED(previous W events, ts=now), RESET]."""
        W = self.length
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)

        count0 = state["count"].clone()    # rows buffered since the boundary
        rank, n_ins = _insert_ranks(valid_cur)
        seq = count0 + rank                # position since the last boundary
        total_after = count0 + n_ins
        S = W + 2                          # a trigger's span: W expired, RESET, CURRENT
        lead = torch.arange(W, dtype=torch.int64, device=dev)

        parts = []
        if self.expired_needed:
            # buffered rows all expire at the first boundary (trigger rank
            # r0 = W - count0), batch rows at the boundary closing their cycle
            r0 = W - count0
            buf_valid = (lead < count0) & (n_ins > r0)
            buf_rows = dict(state["cur"])
            buf_rows[TS_KEY] = torch.where(buf_valid, now, buf_rows[TS_KEY])
            parts.append((buf_rows, _full(W, EXPIRED, torch.int8, dev), buf_valid,
                          r0 * S + lead))
            rb = (torch.div(seq, W, rounding_mode="floor") + 1) * W - count0
            bexp_valid = valid_cur & (n_ins > rb)
            bexp = {k: cols[k] for k in keys}
            bexp[TS_KEY] = torch.where(bexp_valid, now, cols[TS_KEY])
            parts.append((bexp, _full(B, EXPIRED, torch.int8, dev), bexp_valid,
                          rb * S + seq % W))
        is_bnd = valid_cur & (seq > 0) & (seq % W == 0)
        reset_rows = _zero_rows(cols, B, dev)
        reset_rows[TS_KEY] = torch.where(is_bnd, now, 0)
        parts.append((reset_rows, _full(B, RESET, torch.int8, dev), is_bnd,
                      rank * S + W))
        parts.append(({k: cols[k] for k in keys}, _full(B, CURRENT, torch.int8, dev),
                      valid_cur, rank * S + W + 1))
        out, okeys = _order_emit(parts)
        # each arrival is one reference chunk: at a boundary that chunk
        # holds [expired x W, RESET, current] and collapses to its last row
        out[FLUSH_KEY] = _flush_ids(okeys, S)

        # the rows of the still-open cycle stay buffered
        new_count = torch.where(
            total_after > 0,
            total_after - W * torch.div(total_after - 1, W, rounding_mode="floor"),
            0)
        base_seq = total_after - new_count
        keep_old = base_seq == 0
        is_rem = valid_cur & (seq >= base_seq)
        for k in list(state["cur"]):
            old = state["cur"][k]
            base = torch.where(keep_old, old, torch.zeros_like(old))
            state["cur"][k] = _scatter(base, seq - base_seq, cols[k], is_rem)
        state["count"] = new_count
        return state, out

    def apply(self, state, cols, ctx):
        if self.length == 0:
            return self._apply_zero(state, cols, ctx)
        if self.stream_current:
            return self._apply_stream(state, cols, ctx)
        W = self.length
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)

        count0 = state["count"].clone()
        prev_count0 = state["prev_count"].clone()
        cur0, prev0 = dict(state["cur"]), dict(state["prev"])
        rank, n_ins = _insert_ranks(valid_cur)
        seq = count0 + rank               # position in the accumulating stream
        total_after = count0 + n_ins
        n_flush = torch.div(total_after, W, rounding_mode="floor")
        flush_id = torch.div(seq, W, rounding_mode="floor")
        pos_in_flush = seq % W

        # flush f spans [f*S, (f+1)*S): expired block at +0..W-1, RESET at
        # +W, currents at +W+1..2W
        S = 2 * W + 2
        lead = torch.arange(W, dtype=torch.int64, device=dev)

        parts = []
        if self.expired_needed:
            # the previous flush expires in flush 0
            prev_valid = (lead < prev_count0) & (n_flush > 0)
            prev_rows = dict(prev0)
            prev_rows[TS_KEY] = torch.where(prev_valid, now, prev_rows[TS_KEY])
            parts.append((prev_rows, _full(W, EXPIRED, torch.int8, dev),
                          prev_valid, lead))
            # buffered rows (in flush 0) expire in flush 1
            lead_exp_valid = (lead < count0) & (n_flush > 1)
            lead_exp = dict(cur0)
            lead_exp[TS_KEY] = torch.where(lead_exp_valid, now, lead_exp[TS_KEY])
            parts.append((lead_exp, _full(W, EXPIRED, torch.int8, dev),
                          lead_exp_valid, S + lead))
            # batch rows of flush f expire in flush f+1
            bexp_valid = valid_cur & (flush_id + 1 < n_flush)
            bexp = {k: cols[k] for k in keys}
            bexp[TS_KEY] = torch.where(bexp_valid, now, cols[TS_KEY])
            parts.append((bexp, _full(B, EXPIRED, torch.int8, dev), bexp_valid,
                          (flush_id + 1) * S + pos_in_flush))

        n_reset_cap = B // W + 2
        ridx = torch.arange(n_reset_cap, dtype=torch.int64, device=dev)
        reset_valid = ridx < n_flush
        reset_rows = _zero_rows(cols, n_reset_cap, dev)
        reset_rows[TS_KEY] = torch.where(reset_valid, now, 0)
        parts.append((reset_rows, _full(n_reset_cap, RESET, torch.int8, dev),
                      reset_valid, ridx * S + W))
        # currents: buffered rows flush in flush 0...
        lead_valid = (lead < count0) & (n_flush > 0)
        parts.append((dict(cur0), _full(W, CURRENT, torch.int8, dev), lead_valid,
                      W + 1 + lead))
        # ...batch rows of completed flushes flush now
        emitted_now = valid_cur & (flush_id < n_flush)
        parts.append(({k: cols[k] for k in keys}, _full(B, CURRENT, torch.int8, dev),
                      emitted_now, flush_id * S + W + 1 + pos_in_flush))
        out, okeys = _order_emit(parts)
        out[FLUSH_KEY] = _flush_ids(okeys, S)

        # state: remainder rows -> cur; rows of the last completed flush
        # -> prev
        keep_old = n_flush == 0
        rem_slot = torch.where(keep_old, seq, seq - n_flush * W)
        is_rem = valid_cur & (flush_id == n_flush)
        in_last = valid_cur & (flush_id == n_flush - 1)
        lead_in_last = (lead < count0) & (n_flush == 1)
        for k in list(cur0):
            base = torch.where(keep_old, cur0[k], torch.zeros_like(cur0[k]))
            state["cur"][k] = _scatter(base, rem_slot, cols[k], is_rem)
            pbase = torch.where(n_flush > 0, torch.zeros_like(prev0[k]), prev0[k])
            pbase = _scatter(pbase, lead, cur0[k], lead_in_last)
            state["prev"][k] = _scatter(pbase, pos_in_flush, cols[k], in_last)
        state["count"] = total_after - n_flush * W
        state["prev_count"] = torch.where(n_flush > 0, W, prev_count0)
        return state, out

    def contents(self, state):
        """Join/find probes hit the reference's ``expiredEventQueue``
        (LengthBatchWindowProcessor.java:288-299): the last completed batch
        in full-batch mode; the current cycle's arrivals in
        streamCurrentEvents mode."""
        dev = state["count"].device
        if self.length == 0:
            return dict(state["cur"]), torch.zeros((0,), dtype=torch.bool, device=dev)
        j = torch.arange(self.length, dtype=torch.int64, device=dev)
        if self.stream_current:
            return dict(state["cur"]), j < state["count"]
        return dict(state["prev"]), j < state["prev_count"]


# --------------------------------------------------------------- timeBatch

class TimeBatchWindowStage(WindowStage):
    """Tumbling time window; the flush check runs once per chunk (the
    arriving rows join the flushing batch), as the reference processes
    chunks (``TimeBatchWindowProcessor.java:263-345``): [EXPIRED(previous
    batch, ts=now), RESET, CURRENT...]. ``stream_current`` is the
    streamCurrentEvents overload (``:297-335``): CURRENT rows pass at
    arrival, and each flush emits [EXPIRED(arrivals since the last flush,
    ts=now), RESET] after the currents of the flushing chunk."""

    needs_scheduler = True

    batch_mode = True

    def __init__(self, time_ms: int, col_specs: Dict[str, np.dtype], capacity: int,
                 expired_needed: bool = True, start_time: int = -1,
                 stream_current: bool = False):
        self.time_ms = time_ms
        self.capacity = capacity
        self.col_specs = col_specs
        self.expired_needed = expired_needed
        self.start_time = start_time
        self.stream_current = stream_current

    def init_state(self, num_keys: int, device) -> dict:
        Wc = self.capacity

        def zero():
            return {k: torch.zeros((Wc,), dtype=to_torch_dtype(dt), device=device)
                    for k, dt in self.col_specs.items()}

        return {"cur": zero(), "prev": zero(),
                "count": torch.zeros((), dtype=torch.int64, device=device),
                "prev_count": torch.zeros((), dtype=torch.int64, device=device),
                "next_emit": torch.full((), -1, dtype=torch.int64, device=device)}

    def apply(self, state, cols, ctx):
        Wc = self.capacity
        t = self.time_ms
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)

        # the boundary starts at the first chunk (:266-276)
        if self.start_time >= 0:
            init_emit = now + (t - ((now - self.start_time) % t))
        else:
            init_emit = now + t
        next_emit0 = state["next_emit"]
        next_emit = torch.where(next_emit0 < 0, init_emit, next_emit0)
        send = now >= next_emit
        next_emit = torch.where(send, next_emit + t, next_emit)

        count0 = state["count"].clone()
        rank, n_ins = _insert_ranks(valid_cur)
        cur_buf = {k: _scatter(v, count0 + rank, cols[k], valid_cur)
                   for k, v in state["cur"].items()}
        count = count0 + n_ins
        widx = torch.arange(Wc, dtype=torch.int64, device=dev)
        reset_rows = _zero_rows(cols, 1, dev)
        reset_rows[TS_KEY] = _full(1, now, torch.int64, dev)
        reset_valid = (send & (count > 0)).reshape(1)

        if self.stream_current:
            parts = [({k: cols[k] for k in keys}, _full(B, CURRENT, torch.int8, dev),
                      valid_cur, rank)]
            if self.expired_needed:
                # the whole queue, arrivals before and inside the flushing
                # chunk, expires at the flush (:298-314)
                q_valid = (widx < count) & send
                qrows = dict(cur_buf)
                qrows[TS_KEY] = torch.where(q_valid, now, qrows[TS_KEY])
                parts.append((qrows, _full(Wc, EXPIRED, torch.int8, dev), q_valid,
                              B + widx))
            parts.append((reset_rows, _full(1, RESET, torch.int8, dev), reset_valid,
                          _full(1, B + Wc, torch.int64, dev)))
            out, okeys = _order_emit(parts)
            # currents are singleton chunks; the flush's EXPIRED rows share one
            out[FLUSH_KEY] = torch.clamp(okeys, max=B).to(torch.int32)
            state["cur"] = {k: torch.where(send, torch.zeros_like(v), v)
                            for k, v in cur_buf.items()}
            state["count"] = torch.where(send, 0, count)
            state["next_emit"] = next_emit
            out[NOTIFY_KEY] = next_emit
            out[OVERFLOW_KEY] = (count > Wc).to(torch.int32)
            return state, out

        parts = []
        if self.expired_needed:
            prev_valid = (widx < state["prev_count"]) & send
            prev_rows = dict(state["prev"])
            prev_rows[TS_KEY] = torch.where(prev_valid, now, prev_rows[TS_KEY])
            parts.append((prev_rows, _full(Wc, EXPIRED, torch.int8, dev),
                          prev_valid, widx))
        parts.append((reset_rows, _full(1, RESET, torch.int8, dev), reset_valid,
                      _full(1, Wc, torch.int64, dev)))
        cur_valid = (widx < count) & send
        parts.append((dict(cur_buf), _full(Wc, CURRENT, torch.int8, dev), cur_valid,
                      Wc + 1 + widx))
        out, _ = _order_emit(parts)
        out[FLUSH_KEY] = torch.zeros_like(out[TS_KEY], dtype=torch.int32)

        # prev (the findable expiredEventQueue): with expired outputs an
        # empty flush drains it; find-only queries keep the last batch
        replace_prev = send & (self.expired_needed | (count > 0))
        state["prev"] = {k: torch.where(replace_prev, cur_buf[k], v)
                         for k, v in state["prev"].items()}
        state["prev_count"] = torch.where(replace_prev, count, state["prev_count"])
        state["cur"] = {k: torch.where(send, torch.zeros_like(v), v)
                        for k, v in cur_buf.items()}
        state["count"] = torch.where(send, 0, count)
        state["next_emit"] = next_emit
        out[NOTIFY_KEY] = next_emit
        out[OVERFLOW_KEY] = (count > Wc).to(torch.int32)
        return state, out

    def contents(self, state):
        """Join/find probes hit the reference's ``expiredEventQueue``
        (TimeBatchWindowProcessor.java:368-380): the last flushed batch in
        full-batch mode; the arrivals since the last flush in
        streamCurrentEvents mode."""
        j = torch.arange(self.capacity, dtype=torch.int64, device=state["count"].device)
        if self.stream_current:
            return dict(state["cur"]), j < state["count"]
        return dict(state["prev"]), j < state["prev_count"]


class HoppingWindowStage(WindowStage):
    """``hopping(windowTime, hopTime)``: every hop, emit the events of the
    trailing windowTime as a batch (reference HopingWindowProcessor: a
    time batch whose emission period is decoupled from its retention)."""

    needs_scheduler = True

    batch_mode = True

    def __init__(self, window_ms: int, hop_ms: int,
                 col_specs: Dict[str, np.dtype], capacity: int):
        if hop_ms <= 0 or window_ms <= 0:
            raise CompileError("hopping window needs positive window and hop times")
        self.window_ms = window_ms
        self.hop_ms = hop_ms
        self.capacity = capacity
        self.col_specs = col_specs

    def init_state(self, num_keys: int, device) -> dict:
        Wc = self.capacity

        def zero():
            return {k: torch.zeros((Wc,), dtype=to_torch_dtype(dt), device=device)
                    for k, dt in self.col_specs.items()}

        z = lambda: torch.zeros((), dtype=torch.int64, device=device)  # noqa: E731
        return {"buf": zero(), "prev": zero(), "total": z(), "expired_upto": z(),
                "prev_count": z(),
                "next_emit": torch.full((), -1, dtype=torch.int64, device=device)}

    def apply(self, state, cols, ctx):
        Wc = self.capacity
        w, hop = self.window_ms, self.hop_ms
        valid = cols[VALID_KEY]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)

        next_emit0 = state["next_emit"]
        next_emit = torch.where(next_emit0 < 0, now + hop, next_emit0)
        send = now >= next_emit
        next_emit = torch.where(send, next_emit + hop, next_emit)

        # append arrivals to the ts-monotone FIFO ring
        total0 = state["total"].clone()
        exp0 = state["expired_upto"].clone()
        rank, n_ins = _insert_ranks(valid_cur)
        for k, b in state["buf"].items():
            put_where_(b, 0, (total0 + rank) % Wc, cols[k], valid_cur)
        total = total0 + n_ins

        # live FIFO view; rows older than the trailing window can never be
        # emitted again and leave the live range
        widx = torch.arange(Wc, dtype=torch.int64, device=dev)
        fifo_seq = exp0 + widx
        occ = fifo_seq < total
        flat = fifo_seq % Wc
        cur_rows = {k: v[flat] for k, v in state["buf"].items()}
        stale = occ & (cur_rows[TS_KEY] <= now - w)
        new_exp = exp0 + stale.sum(dtype=torch.int64)
        in_window = occ & ~stale & send

        prev_count0 = state["prev_count"].clone()
        prev_valid = (widx < prev_count0) & send
        prev_rows = dict(state["prev"])
        prev_rows[TS_KEY] = torch.where(prev_valid, now, prev_rows[TS_KEY])
        reset_rows = _zero_rows(cols, 1, dev)
        reset_rows[TS_KEY] = _full(1, now, torch.int64, dev)
        parts = [
            (prev_rows, _full(Wc, EXPIRED, torch.int8, dev), prev_valid, widx),
            (reset_rows, _full(1, RESET, torch.int8, dev),
             (send & (prev_count0 > 0)).reshape(1), _full(1, Wc, torch.int64, dev)),
            (cur_rows, _full(Wc, CURRENT, torch.int8, dev), in_window,
             Wc + 1 + widx),
        ]
        out, _ = _order_emit(parts)
        out[FLUSH_KEY] = torch.zeros_like(out[TS_KEY], dtype=torch.int32)

        # the emitted snapshot becomes the next expiry batch (packed)
        emit_rank = torch.cumsum(in_window.to(torch.int64), 0) - 1
        for k, v in list(state["prev"].items()):
            base = torch.where(send, torch.zeros_like(v), v)
            state["prev"][k] = _scatter(base, emit_rank, cur_rows[k], in_window)
        state["total"] = total
        state["expired_upto"] = new_exp
        state["prev_count"] = torch.where(send, in_window.sum(dtype=torch.int64),
                                          prev_count0)
        state["next_emit"] = next_emit
        out[NOTIFY_KEY] = next_emit
        out[OVERFLOW_KEY] = (total - new_exp > Wc).to(torch.int32)
        return state, out

    def contents(self, state):
        Wc = self.capacity
        j = torch.arange(Wc, dtype=torch.int64, device=state["total"].device)
        fifo_seq = state["expired_upto"] + j
        flat = fifo_seq % Wc
        return ({k: v[flat] for k, v in state["buf"].items()},
                fifo_seq < state["total"])


# ------------------------------------------------------------------- batch

class BatchWindowStage(WindowStage):
    """``#window.batch([chunkLength])``: each chunk is its own batch; the
    previous chunk expires first. With ``chunkLength`` the chunk is split
    into sub-batches of at most that many rows, each flushed in turn
    (``BatchWindowProcessor.java:91-118``; the trailing partial group
    still flushes at chunk end)."""

    batch_mode = True

    def __init__(self, col_specs: Dict[str, np.dtype], capacity: int,
                 expired_needed: bool = True, chunk_length: int = 0):
        if chunk_length < 0:
            raise CompileError(
                "batch window chunkLength must be greater than zero")
        self.col_specs = col_specs
        self.capacity = capacity
        self.expired_needed = expired_needed
        self.chunk_length = chunk_length

    def init_state(self, num_keys: int, device) -> dict:
        Wc = self.capacity
        prev = {k: torch.zeros((Wc,), dtype=to_torch_dtype(dt), device=device)
                for k, dt in self.col_specs.items()}
        return {"prev": prev,
                "prev_count": torch.zeros((), dtype=torch.int64, device=device)}

    def apply(self, state, cols, ctx):
        Wc = self.capacity
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
        any_cur = valid_cur.any()
        rank, n_ins = _insert_ranks(valid_cur)
        widx = torch.arange(Wc, dtype=torch.int64, device=dev)
        prev_count0 = state["prev_count"].clone()
        prev0 = dict(state["prev"])

        parts = []
        if self.expired_needed:
            prev_valid = (widx < prev_count0) & any_cur
            prev_rows = dict(prev0)
            prev_rows[TS_KEY] = torch.where(prev_valid, now, prev_rows[TS_KEY])
            parts.append((prev_rows, _full(Wc, EXPIRED, torch.int8, dev),
                          prev_valid, widx))

        if self.chunk_length:
            # n-row flushes: flush f emits [EXPIRED(flush f-1, or the
            # previous chunk for f = 0), RESET, CURRENTs]
            n = self.chunk_length
            flush_id = torch.div(rank, n, rounding_mode="floor")
            n_flush = torch.div(n_ins + n - 1, n, rounding_mode="floor")
            S = Wc + 1 + n
            if self.expired_needed:
                bexp_valid = valid_cur & (flush_id + 1 < n_flush)
                bexp = {k: cols[k] for k in keys}
                bexp[TS_KEY] = torch.where(bexp_valid, now, cols[TS_KEY])
                parts.append((bexp, _full(B, EXPIRED, torch.int8, dev), bexp_valid,
                              (flush_id + 1) * S + rank % n))
            n_reset_cap = B // n + 2
            ridx = torch.arange(n_reset_cap, dtype=torch.int64, device=dev)
            reset_valid = (ridx < n_flush) & ((ridx > 0) | (prev_count0 > 0))
            reset_rows = _zero_rows(cols, n_reset_cap, dev)
            reset_rows[TS_KEY] = torch.where(reset_valid, now, 0)
            parts.append((reset_rows, _full(n_reset_cap, RESET, torch.int8, dev),
                          reset_valid, ridx * S + Wc))
            parts.append(({k: cols[k] for k in keys}, _full(B, CURRENT, torch.int8, dev),
                          valid_cur, flush_id * S + Wc + 1 + rank % n))
            out, okeys = _order_emit(parts)
            out[FLUSH_KEY] = _flush_ids(okeys, S)

            # prev <- rows of the trailing (possibly partial) flush
            base_rank = (n_flush - 1) * n
            is_last = valid_cur & (flush_id == n_flush - 1)
            for k in list(prev0):
                base = torch.where(any_cur, torch.zeros_like(prev0[k]), prev0[k])
                state["prev"][k] = _scatter(base, rank - base_rank, cols[k], is_last)
            state["prev_count"] = torch.where(any_cur, n_ins - base_rank, prev_count0)
            out[OVERFLOW_KEY] = torch.zeros((), dtype=torch.int32, device=dev)
            return state, out

        reset_rows = _zero_rows(cols, 1, dev)
        reset_rows[TS_KEY] = _full(1, now, torch.int64, dev)
        parts.append((reset_rows, _full(1, RESET, torch.int8, dev),
                      (any_cur & (prev_count0 > 0)).reshape(1),
                      _full(1, Wc, torch.int64, dev)))
        idx = torch.arange(B, dtype=torch.int64, device=dev)
        parts.append(({k: cols[k] for k in keys}, cols[TYPE_KEY], valid_cur,
                      Wc + 1 + idx))
        out, _ = _order_emit(parts)
        out[FLUSH_KEY] = torch.zeros_like(out[TS_KEY], dtype=torch.int32)
        for k in list(prev0):
            base = torch.where(any_cur, torch.zeros_like(prev0[k]), prev0[k])
            state["prev"][k] = _scatter(base, rank, cols[k], valid_cur)
        state["prev_count"] = torch.where(any_cur, n_ins, prev_count0)
        out[OVERFLOW_KEY] = (n_ins > Wc).to(torch.int32)
        return state, out

    def contents(self, state):
        j = torch.arange(self.capacity, dtype=torch.int64,
                         device=state["prev_count"].device)
        return dict(state["prev"]), j < state["prev_count"]


# -------------------------------------------------------------- timeLength

class TimeLengthWindowStage(WindowStage):
    """Sliding window bounded by time and count
    (``TimeLengthWindowProcessor``): entries older than t drain on timers;
    when the window holds ``length`` live entries, each arrival evicts the
    oldest. Both evictions drop a FIFO prefix, so one ring of ``length``
    slots suffices. Time expiry inside one chunk is deferred to the timer
    scheduled at once."""

    needs_scheduler = True

    def __init__(self, time_ms: int, length: int, col_specs: Dict[str, np.dtype]):
        if length <= 0:
            raise CompileError("timeLength window needs a positive length")
        self.time_ms = time_ms
        self.length = length
        self.col_specs = col_specs

    def init_state(self, num_keys: int, device) -> dict:
        L = self.length
        buf = {k: torch.zeros((L,), dtype=to_torch_dtype(dt), device=device)
               for k, dt in self.col_specs.items()}
        return {"buf": buf,
                "total": torch.zeros((), dtype=torch.int64, device=device),
                "expired_upto": torch.zeros((), dtype=torch.int64, device=device)}

    def apply(self, state, cols, ctx):
        L = self.length
        t = self.time_ms
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
        now = int(ctx["current_time"])
        STRIDE = L + B + 4
        buf = state["buf"]
        total0 = state["total"].clone()
        exp0 = state["expired_upto"].clone()

        # time drain (a FIFO prefix), before the batch
        j = torch.arange(L, dtype=torch.int64, device=dev)
        fifo_seq = exp0 + j
        occupied = fifo_seq < total0
        fifo_slot = fifo_seq % L
        time_rows = {k: v[fifo_slot] for k, v in buf.items()}
        time_exp = occupied & (time_rows[TS_KEY] + t <= now)
        exp1 = exp0 + time_exp.sum(dtype=torch.int64)
        live0 = total0 - exp1

        # length evictions: insert rank r evicts FIFO entry j = live0 + r - L
        # (when >= 0), the entry of sequence exp1 + j
        rank, n_ins = _insert_ranks(valid_cur)
        n_len = torch.clamp(live0 + n_ins - L, min=0)
        n_len = torch.minimum(n_len, n_ins)
        arange = torch.arange(B, dtype=torch.int64, device=dev)
        rank_to_row = torch.zeros((B,), dtype=torch.int64, device=dev)
        put_where_(rank_to_row, 0, rank, arange, valid_cur)
        lev_seq = exp1 + j
        lev = (j < n_len) & (lev_seq < total0 + n_ins)
        from_batch = lev_seq >= total0
        batch_row = rank_to_row[torch.clamp(lev_seq - total0, 0, B - 1)]
        lev_slot = lev_seq % L
        # eviction j precedes the row of insert rank L - live0 + j
        lev_row = rank_to_row[torch.clamp(L - live0 + j, 0, B - 1)]

        time_rows[TS_KEY] = torch.where(time_exp, now, time_rows[TS_KEY])
        lev_rows = {k: torch.where(from_batch, cols[k][batch_row], v[lev_slot])
                    for k, v in buf.items()}
        lev_rows[TS_KEY] = _full(L, now, torch.int64, dev)
        parts = [
            (time_rows, _full(L, EXPIRED, torch.int8, dev), time_exp, j),
            (lev_rows, _full(L, EXPIRED, torch.int8, dev), lev,
             lev_row * STRIDE + L + j),
            ({k: cols[k] for k in keys}, cols[TYPE_KEY], valid_cur,
             arange * STRIDE + L + B + 2),
        ]
        out, _ = _order_emit(parts)

        # ring update: write the last min(L, n_ins) inserts
        seq = total0 + rank
        write = valid_cur & (rank >= n_ins - L)
        for k, b in buf.items():
            put_where_(b, 0, seq % L, cols[k], write)
        new_total = total0 + n_ins
        new_exp = exp1 + n_len
        fifo2 = new_exp + j
        occ2 = fifo2 < new_total
        ts2 = buf[TS_KEY][fifo2 % L]
        nxt = torch.where(occ2, ts2 + t, _BIG).min()
        out[NOTIFY_KEY] = torch.where(occ2.any(), nxt, -1)
        state["total"].copy_(new_total)
        state["expired_upto"].copy_(new_exp)
        return state, out

    def contents(self, state):
        L = self.length
        total = state["total"]
        j = torch.arange(L, dtype=torch.int64, device=total.device)
        s_j = total - 1 - torch.remainder(total - 1 - j, L)
        valid = (total > 0) & (s_j >= 0) & (s_j >= state["expired_upto"])
        return dict(state["buf"]), valid


# ------------------------------------------------------------------- delay

class DelayWindowStage(WindowStage):
    """``delay(t)``: events are held for t, then released downstream as
    CURRENT with the release time as timestamp
    (``DelayWindowProcessor.java:135-143``). Nothing is emitted on
    arrival. Where the reference emits all ``capacity`` ring items every
    step (most of them invalid), a step emits only the released ones, in
    FIFO order, sized by one host read: a playback delay runs a TIMER
    step per millisecond of event time, each releasing a few rows."""

    needs_scheduler = True

    def __init__(self, delay_ms: int, col_specs: Dict[str, np.dtype], capacity: int):
        self.delay_ms = delay_ms
        self.capacity = capacity
        self.col_specs = col_specs

    def init_state(self, num_keys: int, device) -> dict:
        Wc = self.capacity
        buf = {k: torch.zeros((Wc,), dtype=to_torch_dtype(dt), device=device)
               for k, dt in self.col_specs.items()}
        return {"buf": buf,
                "total": torch.zeros((), dtype=torch.int64, device=device),
                "released_upto": torch.zeros((), dtype=torch.int64, device=device)}

    def apply(self, state, cols, ctx):
        Wc = self.capacity
        d = self.delay_ms
        valid = cols[VALID_KEY]
        dev = valid.device
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
        now = int(ctx["current_time"])
        buf = state["buf"]
        total0 = state["total"].clone()
        rel0 = state["released_upto"].clone()

        j = torch.arange(Wc, dtype=torch.int64, device=dev)
        fifo_seq = rel0 + j
        occupied = fifo_seq < total0
        release = occupied & (buf[TS_KEY][fifo_seq % Wc] + d <= now)
        n_rel = int(release.sum())
        # the released FIFO items in order (one invalid row when there is
        # none: the selector takes no empty chunk)
        m = max(n_rel, 1)
        pos = _mask_positions(release, m)
        rel_rows = {k: v[(rel0 + pos) % Wc] for k, v in buf.items()}
        rel_rows[TS_KEY] = _full(m, now, torch.int64, dev)
        out, _ = _order_emit([
            (rel_rows, _full(m, CURRENT, torch.int8, dev),
             torch.arange(m, device=dev) < n_rel, pos)])

        rank, n_ins = _insert_ranks(valid_cur)
        seq = total0 + rank
        write = valid_cur & (rank >= n_ins - Wc)
        for k, b in buf.items():
            put_where_(b, 0, seq % Wc, cols[k], write)
        new_total = total0 + n_ins
        new_rel = rel0 + release.sum(dtype=torch.int64)
        out[OVERFLOW_KEY] = (new_total - new_rel > Wc).to(torch.int32)
        fifo2 = new_rel + j
        occ2 = fifo2 < new_total
        ts2 = buf[TS_KEY][fifo2 % Wc]
        nxt = torch.where(occ2, ts2 + d, _BIG).min()
        out[NOTIFY_KEY] = torch.where(occ2.any(), nxt, -1)
        state["total"].copy_(new_total)
        state["released_upto"].copy_(new_rel)
        return state, out


# -------------------------------------------------------- externalTimeBatch

class ExternalTimeBatchWindowStage(WindowStage):
    """Tumbling batches by an event-time attribute
    (``ExternalTimeBatchWindowProcessor``): when an event's time crosses
    the window end, the accumulated batch flushes as CURRENT (the previous
    batch as EXPIRED + RESET) and the window slides by whole multiples of
    t. Several flushes can happen inside one chunk. ``timeout`` > 0
    flushes the open batch when no event arrives for ``timeout`` ms of
    the runtime clock (a TIMER chunk); the window end does not move then,
    and the next crossing appends to the already-flushed output
    (``:256-307``)."""

    batch_mode = True

    def __init__(self, ts_fn, time_ms: int, col_specs: Dict[str, np.dtype],
                 capacity: int, expired_needed: bool = True,
                 start_time: int = -1, timeout: int = 0):
        self.expired_needed = expired_needed
        self.ts_fn = ts_fn          # the compiled time attribute expression
        self.time_ms = time_ms
        self.capacity = capacity
        self.col_specs = col_specs
        self.start_time = start_time
        self.timeout = timeout
        self.needs_scheduler = timeout > 0

    def init_state(self, num_keys: int, device) -> dict:
        Wc = self.capacity

        def zero():
            return {k: torch.zeros((Wc,), dtype=to_torch_dtype(dt), device=device)
                    for k, dt in self.col_specs.items()}

        def i64(v):
            return torch.full((), v, dtype=torch.int64, device=device)

        return {"cur": zero(), "prev": zero(), "count": i64(0),
                "prev_count": i64(0), "end": i64(-1),
                "flushed": torch.zeros((), dtype=torch.bool, device=device),
                "last_sched": i64(-1)}

    def apply(self, state, cols, ctx):
        Wc = self.capacity
        t = self.time_ms
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)

        tsv, _m = self.ts_fn(cols, ctx)
        tsv = torch.as_tensor(tsv, device=dev).to(torch.int64).expand(B)

        end_s = state["end"].clone()
        count0 = state["count"].clone()
        prev_count0 = state["prev_count"].clone()
        flushed0 = state["flushed"].clone()
        last_sched0 = state["last_sched"].clone()
        cur0, prev0 = dict(state["cur"]), dict(state["prev"])

        # the first event sets the window end (startTime anchors the grid)
        first_ts = torch.where(
            valid_cur & (torch.cumsum(valid_cur.to(torch.int64), 0) == 1),
            tsv, 0).max()
        if self.start_time >= 0:
            init_end = first_ts - torch.clamp(first_ts - self.start_time, min=0) % t + t
        else:
            init_end = first_ts + t
        end0 = torch.where(end_s < 0, init_end, end_s)

        # each row's grid distance past end0, made monotone against
        # out-of-order timestamps. Flushes are ordinal, one per crossing
        # event however far the time jumped (:285-297); b_i is the batch a
        # row belongs to (0 = the carried open window)
        raw_b = torch.where(tsv >= end0,
                            torch.div(tsv - end0, t, rounding_mode="floor") + 1, 0)
        rawm = torch.cummax(torch.where(valid_cur, raw_b, 0), 0).values
        prev_rawm = torch.cat([rawm.new_zeros(1), rawm[:-1]])
        jump = valid_cur & (rawm > prev_rawm)
        b_i = torch.cumsum(jump.to(torch.int64), 0)
        n_flush = b_i[B - 1]
        max_raw = rawm[B - 1]          # the grid distance the end moves by

        if self.timeout > 0:
            # a timer-driven flush: no event arrived within `timeout`
            has_timer = (valid & (cols[TYPE_KEY] == TIMER)).any()
            timer_fired = has_timer & (last_sched0 >= 0) & (now >= last_sched0)
            due = (timer_fired & (end_s >= 0) & ((count0 > 0) | ~flushed0)
                   & (n_flush == 0))
        else:
            due = torch.zeros((), dtype=torch.bool, device=dev)
        n_flush_eff = torch.where(due, 1, n_flush)
        # flush 1 appends to the batch the timeout already flushed: its
        # prev expiry and RESET are suppressed, prev grows instead
        append1 = flushed0 & (n_flush_eff > 0)
        rank, n_ins = _insert_ranks(valid_cur)

        # flush k's span (k >= 1): expired [0, Wc+B), RESET at Wc+B,
        # currents [Wc+B+1, 2Wc+2B+1)
        S = 2 * Wc + 2 * B + 2
        RESET_OFF = Wc + B
        CUR_OFF = Wc + B + 1
        lead = torch.arange(Wc, dtype=torch.int64, device=dev)
        parts = []
        # prev expires at flush 1, except in append mode, where the
        # appended output continues prev, which then expires at flush 2
        prev_exp_flush = torch.where(append1, 2, 1)
        prev_valid = (lead < prev_count0) & (n_flush_eff >= prev_exp_flush)
        prev_rows = dict(prev0)
        prev_rows[TS_KEY] = torch.where(prev_valid, now, prev_rows[TS_KEY])
        parts.append((prev_rows, _full(Wc, EXPIRED, torch.int8, dev), prev_valid,
                      prev_exp_flush * S + lead))
        # the carried cur buffer (window 0): CURRENT at flush 1, EXPIRED at 2
        carry_valid = (lead < count0) & (n_flush_eff > 0)
        parts.append((dict(cur0), _full(Wc, CURRENT, torch.int8, dev), carry_valid,
                      S + CUR_OFF + lead))
        carry_exp_valid = (lead < count0) & (n_flush_eff > 1)
        carry_exp = dict(cur0)
        carry_exp[TS_KEY] = torch.where(carry_exp_valid, now, carry_exp[TS_KEY])
        parts.append((carry_exp, _full(Wc, EXPIRED, torch.int8, dev),
                      carry_exp_valid, 2 * S + lead))
        # batch rows of window k: CURRENT at flush k+1, EXPIRED at k+2
        cur_valid = valid_cur & (b_i < n_flush_eff)
        parts.append(({k: cols[k] for k in keys}, _full(B, CURRENT, torch.int8, dev),
                      cur_valid, (b_i + 1) * S + CUR_OFF + Wc + rank))
        bexp_valid = valid_cur & (b_i + 1 < n_flush_eff)
        bexp = {k: cols[k] for k in keys}
        bexp[TS_KEY] = torch.where(bexp_valid, now, cols[TS_KEY])
        parts.append((bexp, _full(B, EXPIRED, torch.int8, dev), bexp_valid,
                      (b_i + 2) * S + Wc + rank))
        # one RESET per flush, between its expired rows and its currents
        n_reset_cap = B + 2
        ridx = torch.arange(n_reset_cap, dtype=torch.int64, device=dev)
        reset_valid = ((ridx >= 1) & (ridx <= n_flush_eff)
                       & ~(append1 & (ridx == 1)))
        reset_rows = _zero_rows(cols, n_reset_cap, dev)
        reset_rows[TS_KEY] = torch.where(reset_valid, now, 0)
        parts.append((reset_rows, _full(n_reset_cap, RESET, torch.int8, dev),
                      reset_valid, ridx * S + RESET_OFF))
        out, okeys = _order_emit(parts)
        out[FLUSH_KEY] = _flush_ids(okeys, S)

        # ---- state
        keep_old = n_flush_eff == 0
        is_rem = valid_cur & (b_i == n_flush_eff)          # open-window rows
        rem_rank = torch.cumsum(is_rem.to(torch.int64), 0) - 1
        base_cnt = torch.where(keep_old, count0, 0)
        # prev <- window n_flush_eff - 1: the carry buffer when it is
        # window 0, then that window's batch rows
        in_last = valid_cur & (b_i == n_flush_eff - 1) & (n_flush_eff > 0)
        last_rank = torch.cumsum(in_last.to(torch.int64), 0) - 1
        carry_in_last = (lead < count0) & (n_flush_eff == 1)
        # append mode: the flushed batch is already in prev, which grows
        app = append1 & (n_flush_eff == 1)
        app_off = torch.where(app, prev_count0, 0)
        n_carry_last = torch.where(n_flush_eff == 1, count0, 0)
        for k in list(cur0):
            base = torch.where(keep_old, cur0[k], torch.zeros_like(cur0[k]))
            state["cur"][k] = _scatter(base, base_cnt + rem_rank, cols[k], is_rem)
            pbase = torch.where((n_flush_eff > 0) & ~app,
                                torch.zeros_like(prev0[k]), prev0[k])
            pbase = _scatter(pbase, app_off + lead, cur0[k], carry_in_last)
            state["prev"][k] = _scatter(pbase, app_off + n_carry_last + last_rank,
                                        cols[k], in_last)
        new_count = base_cnt + is_rem.sum(dtype=torch.int64)
        n_last = in_last.sum(dtype=torch.int64) + n_carry_last
        new_prev_count = torch.where(
            n_flush_eff > 0, n_last + torch.where(app, prev_count0, 0), prev_count0)
        any_first = valid_cur.any()
        state["end"] = torch.where(
            end_s < 0, torch.where(any_first, end0 + max_raw * t, -1),
            end0 + max_raw * t)
        state["count"] = new_count
        state["prev_count"] = new_prev_count
        out[OVERFLOW_KEY] = ((new_count > Wc) | (new_prev_count > Wc)).to(torch.int32)
        state["flushed"] = torch.where(n_flush > 0, False,
                                       torch.where(due, True, flushed0))
        if self.timeout > 0:
            # a firing timer always moves the schedule, due or not, as the
            # reference's timer branch reschedules unconditionally
            # (:270-274); a stale last_sched <= now would re-notify the
            # same instant forever
            resched = due | timer_fired | (n_flush > 0) | ((end_s < 0) & any_first)
            new_sched = torch.where(resched, now + self.timeout, last_sched0)
            state["last_sched"] = new_sched
            out[NOTIFY_KEY] = torch.where(new_sched >= 0, new_sched, -1)
        return state, out

    def contents(self, state):
        j = torch.arange(self.capacity, dtype=torch.int64, device=state["count"].device)
        return dict(state["cur"]), j < state["count"]


# ----------------------------------------------------------------- factory

def _external_ts_key(window, input_def) -> str:
    """externalTime's clock column: a plain LONG attribute reference
    (anything else fails app creation, as in the reference processor)."""
    from siddhi_tpu_torch.query_api.expressions import Variable

    p0 = window.parameters[0] if window.parameters else None
    if isinstance(p0, Variable):
        attr = input_def.attribute(p0.attribute_name)
        if attr.type != AttrType.LONG:
            raise CompileError(
                "externalTime timestamp attribute must be long (ms epoch)")
        return attr.name
    raise CompileError(
        f"{window.name} window's first parameter must be a long attribute "
        "reference (the external timestamp)")


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


def _bool_const_param(window: Window, i: int, name: str) -> bool:
    p = window.parameters[i]
    if not (isinstance(p, Constant) and isinstance(p.value, bool)):
        raise CompileError(
            f"{window.name} window parameter '{name}' must be a bool constant")
    return p.value


def create_window_stage(window: Window, input_def, resolver, app_context,
                        expired_needed: bool = True) -> WindowStage:
    """Build a window stage from a ``#window.<name>(params)`` handler: the
    factory role of reference ``SingleInputStreamParser.generateProcessor``
    plus each window's ``init`` validation. ``expired_needed=False`` is the
    reference's outputExpectsExpiredEvents=false: batch windows skip their
    expired emission. The map and comparator windows run on the host
    (``ops/host_windows.py``)."""
    name = window.name.lower()
    col_specs = window_col_specs(input_def)
    capacity = getattr(app_context, "window_capacity", 4096)

    if name == "length":
        _expect_arity(window, 1, 1)
        return LengthWindowStage(_int_const_param(window, 0, "length"), col_specs)
    if name == "lengthbatch":
        # lengthBatch(length[, streamCurrentEvents])
        _expect_arity(window, 1, 2)
        stream_current = False
        if len(window.parameters) == 2:
            stream_current = _bool_const_param(window, 1, "streamCurrentEvents")
        return LengthBatchWindowStage(_int_const_param(window, 0, "length"), col_specs,
                                      expired_needed=expired_needed,
                                      stream_current=stream_current)
    if name == "time":
        _expect_arity(window, 1, 1)
        return TimeWindowStage(_int_const_param(window, 0, "time"), col_specs, capacity)
    if name == "externaltime":
        # externalTime(tsAttr, time): expiry driven by the named long
        # timestamp attribute
        _expect_arity(window, 2, 2)
        ts_key = _external_ts_key(window, input_def)
        return TimeWindowStage(_int_const_param(window, 1, "time"), col_specs, capacity,
                               external=True, ts_key=ts_key)
    if name == "timebatch":
        # overloads (TimeBatchWindowProcessor.init): (time),
        # (time, startTime int/long), (time, streamCurrentEvents bool),
        # (time, startTime, streamCurrentEvents)
        _expect_arity(window, 1, 3)
        start_time = -1
        stream_current = False
        if len(window.parameters) == 2:
            p1 = window.parameters[1]
            if isinstance(p1, Constant) and isinstance(p1.value, bool):
                stream_current = p1.value
            elif (isinstance(p1, TimeConstant)
                  or (isinstance(p1, Constant)
                      and p1.type in (AttrType.INT, AttrType.LONG))):
                start_time = int(p1.value)
            else:
                raise CompileError(
                    "timeBatch second parameter must be an int/long startTime "
                    "or a bool streamCurrentEvents constant")
        elif len(window.parameters) == 3:
            start_time = _int_const_param(window, 1, "startTime")
            stream_current = _bool_const_param(window, 2, "streamCurrentEvents")
        return TimeBatchWindowStage(_int_const_param(window, 0, "time"), col_specs,
                                    capacity, expired_needed=expired_needed,
                                    start_time=start_time,
                                    stream_current=stream_current)
    if name == "batch":
        # batch([chunkLength]) (BatchWindowProcessor.java:107-118)
        _expect_arity(window, 0, 1)
        chunk_length = 0
        if window.parameters:
            chunk_length = _int_const_param(window, 0, "chunkLength")
        return BatchWindowStage(col_specs, capacity, expired_needed=expired_needed,
                                chunk_length=chunk_length)
    if name == "timelength":
        _expect_arity(window, 2, 2)
        return TimeLengthWindowStage(_int_const_param(window, 0, "time"),
                                     _int_const_param(window, 1, "length"), col_specs)
    if name == "delay":
        _expect_arity(window, 1, 1)
        return DelayWindowStage(_int_const_param(window, 0, "delay"), col_specs, capacity)
    if name == "externaltimebatch":
        # externalTimeBatch(tsAttr, time[, startTime[, timeout]])
        from siddhi_tpu_torch.ops.expressions import compile_expr

        _expect_arity(window, 2, 4)
        ts_fn, _t = compile_expr(window.parameters[0], resolver)
        start_time = -1
        if len(window.parameters) >= 3:
            p = window.parameters[2]
            if not isinstance(p, (Constant, TimeConstant)):
                raise CompileError(
                    "externalTimeBatch startTime must be a constant")
            start_time = int(p.value)
        timeout = 0
        if len(window.parameters) >= 4:
            timeout = _int_const_param(window, 3, "timeout")
        return ExternalTimeBatchWindowStage(
            ts_fn, _int_const_param(window, 1, "time"), col_specs, capacity,
            expired_needed=expired_needed, start_time=start_time,
            timeout=timeout)
    if name == "hopping":
        _expect_arity(window, 2, 2)
        return HoppingWindowStage(
            _int_const_param(window, 0, "windowTime"),
            _int_const_param(window, 1, "hopTime"), col_specs, capacity)
    if name in ("sort", "frequent", "lossyfrequent", "session", "cron",
                "expression", "expressionbatch"):
        from siddhi_tpu_torch.ops.host_windows import create_host_window_stage

        return create_host_window_stage(window, input_def, resolver, app_context)
    raise CompileError(f"window '{window.name}' is not implemented yet")
