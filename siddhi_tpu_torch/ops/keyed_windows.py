"""Per-partition-key window stages: dense ``[K, W]`` ring buffers.

Counterpart of ``siddhi_tpu/ops/keyed_windows.py``. Inside ``partition with
(...)`` the reference gives every key its own window processor; here all
keys share one state tensor per column: flat ``[K*W]`` rings (key ``k``
owns slots ``[k*W, (k+1)*W)``) or ``[K, W]`` buffers, so key-capacity
growth is a prefix copy and one batch updates every key's window with
gathers and scatters, no per-key loop. The stages update their state in
place (``ops/scatter.put_where_``) where the reference rebuilt it under a
donated jit.

Each stage emits the reference's valid rows in the reference's order (one
stable sort by an order key per emitted row, invalid rows last):
- length: sliding; when key k's window is full, each arrival on k emits
  [EXPIRED(oldest of k, ts=now), CURRENT] (``LengthWindowProcessor``).
- time / timeLength / externalTime: sliding FIFO rings per key. Where the
  reference emits all ``K*Wc`` ring slots every step (most of them
  invalid) and sorts them, the port counts each key's expiring items with
  one masked pass over the ring and emits only those, compacted in the
  reference's key-major FIFO order: a step sorts O(expiring + B) rows,
  not 4.2 M at K = 16,384 and Wc = 256. A TIMER step given
  ``ctx["horizon"]`` sweeps the chain of timers up to it (every key's live
  rows in time order): each row expires stamped at the tick that would
  have expired it, max(now, ts + t).
- session(gap): per-key sessions; in-batch breaks come from a closed form
  (row i of key k breaks when ts_i > its previous same-key row's ts (or
  the state's ``last``) + gap), not one round per same-key occurrence over
  ``[B, W]`` lanes; the idle sweep drains at most 128 due keys a step in
  key order, and a swept TIMER step drains them chunk by chunk in (tick,
  key) order, the overflow keys of a tick in further chunks at that tick.
- lengthBatch, timeBatch, batch, hopping: per-key tumbling/hopping flushes
  [EXPIRED(prev), RESET, CURRENT(batch)], as the reference computes them.

The partition key id column is ``PK_KEY`` (host-computed dense ids).
Under the key-sharded step across processes (``parallel/mesh.py``
``shard_query_step``) a stage holds only its process's keys, and
``ctx["key_split"]`` (a :class:`KeySplit`) has it take its order keys and
its compaction ranks over the global key space, so every process's
emitted rows merge into the unsharded order (``split_aware`` stages).
Every stage is ``keyed``: its ``contents`` is a per-key ``[K, W]`` probe
surface, so it can be a join side inside a partition.
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
    CHUNK_KEY,
    CURRENT,
    EXPIRED,
    FLUSH_KEY,
    NOTIFY_KEY,
    OVERFLOW_KEY,
    RESET,
    WindowStage,
    _BIG,
    _data_keys,
    _full,
    _mask_positions,
    _order_emit,
    _row_order_base,
    _zero_rows,
)


class KeySplit:
    """How a keyed stage sees the key-sharded step across processes: it
    holds the keys ``g = l * n + first`` (local id ``l``) of the ``n``
    processes' global key space. ``gather(t)`` is every process's copy of
    ``t`` in process order, ``gather_rows(t)`` the same for a ``t`` whose
    row count differs between processes (each one collective: every
    process calls it at the same point of the same step)."""

    def __init__(self, n: int, first: int, gather, gather_rows):
        self.n = n
        self.first = first
        self.gather = gather
        self.gather_rows = gather_rows

    def keys(self, local: torch.Tensor) -> torch.Tensor:
        """Global ids of local key ids."""
        return local * self.n + self.first

    def capacity(self, K: int) -> int:
        """The global key capacity of ``K`` local keys a process."""
        return K * self.n

    def due_ranks(self, due: torch.Tensor):
        """(each local key's rank among every process's ``due`` keys in
        global key order, the global count of due keys)."""
        d = torch.stack(self.gather(due.to(torch.int64)))      # [n, K]
        per_l = d.sum(0)
        rank = (torch.cumsum(per_l, 0) - per_l) + d[:self.first].sum(0)
        return rank, d.sum()

    def with_foreign_resets(self, cols: Dict) -> Dict:
        """A batch window's emission with every other process's RESET rows
        in their global places (by ``OKEY_KEY``): a RESET restarts every
        group's aggregates (``ops/aggregators.py``), its own key's or not,
        so each process's selector sees them all, as the unsharded one
        does. The RESET rows are never emitted."""
        okey, valid = cols[OKEY_KEY], cols[VALID_KEY]
        B = valid.shape[0]
        mine = okey[valid & (cols[TYPE_KEY] == RESET)]
        parts = self.gather_rows(mine)
        foreign = torch.cat([p for q, p in enumerate(parts) if q != self.first])
        m = foreign.shape[0]
        if m == 0:
            return cols
        out = dict(cols)
        rows = [k for k, v in cols.items()
                if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == B]
        for k in rows:
            v = cols[k]
            pad = torch.zeros((m,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
            if k == TYPE_KEY:
                pad.fill_(RESET)
            elif k == VALID_KEY:
                pad.fill_(True)
            elif k == OKEY_KEY:
                pad = foreign.to(v.dtype)
            out[k] = torch.cat([v, pad])
        order = torch.argsort(torch.where(out[VALID_KEY], out[OKEY_KEY],
                                          torch.full_like(out[OKEY_KEY], _BIG)),
                              stable=True)
        for k in rows:
            out[k] = out[k][order]
        return out


def _global_keys(ctx, local: torch.Tensor) -> torch.Tensor:
    """The global ids of local key ids (themselves unless split)."""
    ks = ctx.get("key_split")
    return local if ks is None else ks.keys(local)


def _global_capacity(ctx, K: int) -> int:
    ks = ctx.get("key_split")
    return K if ks is None else ks.capacity(K)


def _due_ranks(ctx, due: torch.Tensor):
    """(rank of each due key among the due keys in global key order, the
    count of due keys), over every process under a split."""
    ks = ctx.get("key_split")
    if ks is None:
        return torch.cumsum(due.to(torch.int64), 0) - 1, due.sum()
    return ks.due_ranks(due)


def _with_okey(out, okey, cols):
    """Hand the emission-order keys on where shards merge by them: the
    routed step and the key-sharded step across processes attach
    ``RIDX_KEY``."""
    if RIDX_KEY in cols:
        out[OKEY_KEY] = okey
    return out


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


def _per_key_count(mask, pk, K: int):
    """[K] count of the rows in ``mask`` per key."""
    idx = torch.where(mask, pk, torch.full_like(pk, K))
    return torch.zeros(K + 1, dtype=torch.int64, device=pk.device).index_add_(
        0, idx, torch.ones_like(idx))[:K]


def _key_flags(mask, pk, K: int):
    """[K] bool: some row in ``mask`` has this key."""
    return _per_key_count(mask, pk, K) > 0


def _expand(counts, n: int):
    """The ``n = counts.sum()`` items of per-group ``counts``, in group
    order: (group, rank within its group) of each."""
    dev = counts.device
    cum = torch.cumsum(counts, 0)
    p = torch.arange(n, dtype=torch.int64, device=dev)
    g = torch.searchsorted(cum, p, right=True)
    return g, p - (cum[g] - counts[g])


def _ring_buffers(col_specs, n: int, device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((n,), dtype=to_torch_dtype(dt), device=device)
            for k, dt in col_specs.items()}


class KeyedLengthWindowStage(WindowStage):
    """Sliding length window per partition key."""

    keyed = True
    # its order keys are batch positions: global wherever rows came from
    split_aware = True
    # no host read, the clock taken as a tensor: a partitioned step (the
    # routed flagship's included) may run inside a CUDA graph
    capturable = True

    def __init__(self, length: int, col_specs: Dict[str, np.dtype]):
        if length <= 0:
            raise CompileError("length window needs a positive length")
        self.length = length
        self.col_specs = col_specs

    def init_state(self, num_keys: int, device) -> dict:
        return {"buf": _ring_buffers(self.col_specs, num_keys * self.length, device),
                "total": torch.zeros((num_keys,), dtype=torch.int64,
                                     device=device)}

    @property
    def ring_capacity(self) -> int:
        return self.length

    def live_fill(self, state) -> torch.Tensor:
        """The hottest key's live rows: the ``win_fill`` instrument slot
        (the max, not the sum: a key's ring is what overflows)."""
        return torch.clamp(state["total"], max=self.length).max()

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
        expired[TS_KEY] = _full(B, ctx["current_time"], torch.int64, dev)

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
        return state, _with_okey(out, okey, cols)

    def contents(self, state):
        """Per-key probe surface: ([K, W] cols, [K, W] valid)."""
        W = self.length
        K = state["total"].shape[0]
        cols = {k: v.reshape(K, W) for k, v in state["buf"].items()}
        j = torch.arange(W, dtype=torch.int64, device=state["total"].device)[None, :]
        return cols, j < torch.clamp(state["total"], max=W)[:, None]

    def reset_keys(self, state, ids):
        """@purge: restart purged keys' windows (rows become unreachable
        as soon as total is zeroed)."""
        state["total"].index_fill_(0, ids, 0)
        return state


class KeyedTimeWindowStage(WindowStage):
    """Sliding time window per partition key. Each key keeps a FIFO ring of
    capacity ``Wc``; a step expires the occupied items with ts + t <= now
    (the reference's ``[K, Wc]`` mask, counted in one pass) and emits only
    those, in key-major FIFO order (order key k*Wc + j), then per batch row
    its same-key in-batch expirees and itself (anchor-major keys).

    ``external=True`` is externalTime: each key's cutoff clock advances only
    with that key's own events; an item expires just before the first
    same-key row whose clock covers it (a composite (key, ts) searchsorted
    over the key-grouped batch), and keeps its timestamp.

    ``max_len`` is timeLength: on top of time expiry, each insert beyond
    ``max_len`` live rows evicts its key's oldest row, emitted EXPIRED just
    before the displacing insert (TimeLengthWindowProcessor per key)."""

    keyed = True
    split_aware = True

    def __init__(self, time_ms: int, col_specs: Dict[str, np.dtype], capacity: int,
                 external: bool = False, max_len: int = None,
                 ts_key: str = TS_KEY):
        if external and max_len is not None:
            raise CompileError("externalTime cannot combine with a length cap")
        self.time_ms = time_ms
        self.capacity = max(capacity, max_len) if max_len is not None else capacity
        self.col_specs = col_specs
        self.external = external
        self.needs_scheduler = not external
        self.max_len = max_len
        self.ts_key = ts_key    # externalTime clock column (attribute)

    def init_state(self, num_keys: int, device) -> dict:
        z = torch.zeros((num_keys,), dtype=torch.int64, device=device)
        return {"buf": _ring_buffers(self.col_specs, num_keys * self.capacity, device),
                "total": z, "expired_upto": z.clone()}

    @property
    def ring_capacity(self) -> int:
        return self.capacity

    def live_fill(self, state) -> torch.Tensor:
        """The hottest key's live (unexpired) rows: the ``win_fill``
        instrument slot."""
        return torch.clamp(state["total"] - state["expired_upto"], min=0).max()

    def apply(self, state, cols, ctx):
        Wc = self.capacity
        t = self.time_ms
        buf = state["buf"]
        total0 = state["total"].clone()
        exp0 = state["expired_upto"].clone()
        K = total0.shape[0]
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
        ts = cols[TS_KEY]
        pk = torch.clamp(cols[PK_KEY].to(torch.int64), 0, K - 1)
        B_idx = torch.arange(B, dtype=torch.int64, device=dev)

        # [K, Wc] FIFO view of every key's ring: item j of key k holds
        # sequence exp0[k] + j
        j = torch.arange(Wc, dtype=torch.int64, device=dev)
        kar = torch.arange(K, dtype=torch.int64, device=dev)
        fifo_seq = exp0[:, None] + j[None, :]
        occupied = fifo_seq < total0[:, None]
        fifo_flat = kar[:, None] * Wc + fifo_seq % Wc

        order, _inv, occ, counts, start_pos = _per_key_layout(pk, valid_cur, K)

        # order keys over the global key space: ring position g*Wc + j of
        # global key g (a split's; the local space otherwise)
        KWc_o = _global_capacity(ctx, K) * Wc

        def gpos(pos):
            return _global_keys(ctx, pos // Wc) * Wc + pos % Wc

        if self.external:
            return self._apply_external(state, cols, keys, valid_cur, pk, order,
                                        occ, counts, occupied, fifo_flat, B_idx, now,
                                        ctx, KWc_o, gpos)

        ring_ts = buf[TS_KEY][fifo_flat]
        horizon = ctx.get("horizon")
        if horizon is not None:
            # a swept chain expires a FIFO prefix of every key at each
            # tick: it needs every key's live rows in time order (every
            # process's keys, under a split)
            in_order = ((ring_ts[:, 1:] >= ring_ts[:, :-1]) | ~occupied[:, 1:]).all()
            ks = ctx.get("key_split")
            if ks is not None:
                in_order = torch.stack(ks.gather(in_order.reshape(1))).all()
            if not bool(in_order):
                horizon = None
        cut = now if horizon is None else horizon
        expire_ring = occupied & (ring_ts + t <= cut)
        n_exp_per_key = expire_ring.sum(1)

        # within-batch expiry: a row whose ts is already older than the
        # cutoff expires before the next CURRENT row of the same key
        has_next = (occ + 1) < counts[pk]
        nxt = torch.where(has_next, order[torch.clamp(start_pos + occ + 1, max=B - 1)],
                          torch.full_like(occ, B))
        batch_exp = valid_cur & (ts + t <= now) & (nxt < B)
        STRIDE_A = KWc_o + B + 2

        if self.max_len is not None:
            # timeLength: drain oldest rows so each key's live count stays
            # <= L, each evictee anchored before its displacer (the insert
            # L sequence numbers later)
            L = self.max_len
            E = exp0 + n_exp_per_key + _per_key_count(batch_exp, pk, K)
            n_len = torch.clamp(total0 + counts - L - E, min=0)
            start_key = torch.full((K + 1,), B, dtype=torch.int64, device=dev).scatter_reduce(
                0, torch.where(valid_cur, pk, K), start_pos, "amin")[:K]
            jlo = E - exp0
            jhi = torch.minimum(jlo + n_len, torch.clamp(total0 - exp0, 0, Wc))
            n_lring = torch.clamp(jhi - jlo, min=0)
            n1, n2 = torch.stack([n_exp_per_key.sum(), n_lring.sum()]).tolist()
        else:
            n1 = n_exp_per_key.sum().tolist()   # one explicit host read
        # the expiring ring items, compacted (the reference emits all K*Wc)
        rpos = _mask_positions(expire_ring, n1)      # k*Wc + j, in order
        rslot = fifo_flat.reshape(-1)[rpos]
        # every ring read happens before the ring is written below
        ring_rows = {c: v[rslot] for c, v in buf.items()}
        if horizon is None:
            ring_rows[TS_KEY] = _full(n1, now, torch.int64, dev)
            ring_okey = gpos(rpos)
        else:
            # each row at the tick that would have expired it
            tick = torch.clamp(ring_rows[TS_KEY] + t, min=now)
            ring_rows[TS_KEY] = tick
            ring_okey = (tick - now) * KWc_o + gpos(rpos)
        batch_exp_rows = {c: cols[c] for c in keys}
        batch_exp_rows[TS_KEY] = _full(B, now, torch.int64, dev)
        parts = [
            (ring_rows, _full(n1, EXPIRED, torch.int8, dev),
             torch.ones((n1,), dtype=torch.bool, device=dev), ring_okey),
            (batch_exp_rows, _full(B, EXPIRED, torch.int8, dev), batch_exp,
             (nxt + 1) * STRIDE_A + KWc_o + B_idx),
            ({c: cols[c] for c in keys}, cols[TYPE_KEY], valid_cur,
             (B_idx + 1) * STRIDE_A + KWc_o + B + 1),
        ]
        if self.max_len is not None:
            lk, lr = _expand(n_lring, n2)
            lj = jlo[lk] + lr
            lseq = exp0[lk] + lj
            len_rows = {c: v[lk * Wc + lseq % Wc] for c, v in buf.items()}
            len_rows[TS_KEY] = _full(n2, now, torch.int64, dev)
            anchor_r = order[torch.clamp(start_key[lk] + (lseq + L - total0[lk]), 0, B - 1)]
            seq_b = total0[pk] + occ
            len_batch = valid_cur & (seq_b >= E[pk]) & (seq_b < (E + n_len)[pk])
            anchor_b = order[torch.clamp(start_pos + occ + L, 0, B - 1)]
            parts += [
                (len_rows, _full(n2, EXPIRED, torch.int8, dev),
                 torch.ones((n2,), dtype=torch.bool, device=dev),
                 (anchor_r + 1) * STRIDE_A + _global_keys(ctx, lk) * Wc + lj),
                (batch_exp_rows, _full(B, EXPIRED, torch.int8, dev), len_batch,
                 (anchor_b + 1) * STRIDE_A + KWc_o + B_idx),
            ]
            new_exp = E + n_len        # time drain + length evictions
        else:
            new_exp = exp0 + n_exp_per_key + _per_key_count(batch_exp, pk, K)
        out, okey = _order_emit(parts)
        _with_okey(out, okey, cols)
        new_total = self._append(state, cols, valid_cur, pk, occ, counts, total0)
        fifo2 = new_exp[:, None] + j[None, :]
        occ2 = fifo2 < new_total[:, None]
        ts2 = buf[TS_KEY][kar[:, None] * Wc + fifo2 % Wc]
        nxt_notify = torch.where(occ2, ts2 + t, _BIG).min()
        out[NOTIFY_KEY] = torch.where(occ2.any(), nxt_notify, -1)
        return self._finish(state, out, new_total, new_exp)

    def _apply_external(self, state, cols, keys, valid_cur, pk, order, occ,
                        counts, occupied, fifo_flat, B_idx, now, ctx, KWc_o, gpos):
        Wc = self.capacity
        t = self.time_ms
        buf = state["buf"]
        total0 = state["total"].clone()
        exp0 = state["expired_upto"].clone()
        K = total0.shape[0]
        B = valid_cur.shape[0]
        dev = valid_cur.device
        M = 1 << 42      # > any ms epoch until ~2109
        ck = cols[self.ts_key]
        ts_c = torch.clamp(ck, 0, M - 1)
        safe_pk = torch.where(valid_cur, pk, torch.full_like(pk, K))
        spk_sorted = safe_pk[order]
        # a backwards clock would leave the composite keys unsorted; the
        # running max over the grouped composite is a per-key running max
        # (the key holds the high bits and groups ascend)
        comp_sorted = torch.cummax(spk_sorted * M + ts_c[order], 0).values

        def first_covering(keys_of, item_ts):
            tgt = keys_of * M + torch.clamp(item_ts + t, 0, M - 1)
            pos = torch.searchsorted(comp_sorted, tgt)
            posc = torch.clamp(pos, max=B - 1)
            ok = (pos < B) & (spk_sorted[posc] == keys_of)
            return ok, torch.where(ok, order[posc], torch.full_like(pos, B))

        # a ring item is covered iff its key's clock reaches item + t in
        # this batch: the search lands inside the key's group exactly then
        seg_max = torch.full((K + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
            0, safe_pk, ts_c, "amax")[:K]
        ring_ck = buf[self.ts_key][fifo_flat]
        expire_ring = occupied & (torch.clamp(ring_ck + t, 0, M - 1) <= seg_max[:, None])
        n_exp_per_key = expire_ring.sum(1)
        n1 = n_exp_per_key.sum().tolist()   # one explicit host read
        rpos = _mask_positions(expire_ring, n1)
        rslot = fifo_flat.reshape(-1)[rpos]
        ring_rows = {c: v[rslot] for c, v in buf.items()}   # timestamps kept
        _ok, ring_anchor = first_covering(rpos // Wc, ring_rows[self.ts_key])
        batch_cov, nxt = first_covering(safe_pk, ck)
        batch_exp = valid_cur & batch_cov
        # anchor-major order: everything anchored before batch row a sorts
        # between rows a-1 and a
        STRIDE2 = KWc_o + B + 2
        parts = [
            (ring_rows, _full(n1, EXPIRED, torch.int8, dev),
             torch.ones((n1,), dtype=torch.bool, device=dev),
             ring_anchor * STRIDE2 + gpos(rpos)),
            ({c: cols[c] for c in keys}, _full(B, EXPIRED, torch.int8, dev),
             batch_exp, nxt * STRIDE2 + KWc_o + B_idx),
            ({c: cols[c] for c in keys}, cols[TYPE_KEY], valid_cur,
             B_idx * STRIDE2 + KWc_o + B + 1),
        ]
        out, okey = _order_emit(parts)
        _with_okey(out, okey, cols)
        new_total = self._append(state, cols, valid_cur, pk, occ, counts, total0)
        new_exp = exp0 + n_exp_per_key + _per_key_count(batch_exp, pk, K)
        out[NOTIFY_KEY] = torch.full((), -1, dtype=torch.int64, device=dev)
        return self._finish(state, out, new_total, new_exp)

    def _append(self, state, cols, valid_cur, pk, occ, counts, total0):
        """Append the inserted rows to their keys' rings (the last Wc of a
        key when more arrive); returns the new totals."""
        Wc = self.capacity
        seq = total0[pk] + occ
        write = valid_cur & (occ >= counts[pk] - Wc)
        for c, b in state["buf"].items():
            put_where_(b, 0, pk * Wc + seq % Wc, cols[c], write)
        return total0 + counts

    def _finish(self, state, out, new_total, new_exp):
        out[OVERFLOW_KEY] = (new_total - new_exp > self.capacity).any().to(torch.int32)
        state["total"].copy_(new_total)
        state["expired_upto"].copy_(new_exp)
        return state, out

    def contents(self, state):
        """Per-key probe surface: slot j of key k is live iff some sequence
        s in [expired_upto, total) lands on it (s % Wc == j)."""
        Wc = self.capacity
        K = state["total"].shape[0]
        cols = {k: v.reshape(K, Wc) for k, v in state["buf"].items()}
        j = torch.arange(Wc, dtype=torch.int64, device=state["total"].device)[None, :]
        exp0 = state["expired_upto"][:, None]
        live = state["total"][:, None] - exp0
        return cols, ((j - exp0 % Wc) % Wc) < live

    def reset_keys(self, state, ids):
        state["total"].index_fill_(0, ids, 0)
        state["expired_upto"].index_fill_(0, ids, 0)
        return state


class KeyedLengthBatchWindowStage(WindowStage):
    """Tumbling count batches per partition key (reference
    LengthBatchWindowProcessor applied per key): key k's Nth arrival
    flushes [EXPIRED(previous batch), RESET, CURRENT(batch)]. A chunk can
    complete several batches for one key: emission rows gather from the
    stored partial ring, the stored previous batch, or earlier rows of the
    same chunk by absolute per-key sequence number."""

    keyed = True
    # its order keys are batch positions
    split_aware = True

    batch_mode = True

    def __init__(self, length: int, col_specs: Dict[str, np.dtype]):
        if length <= 0:
            raise CompileError("lengthBatch window needs a positive length")
        self.length = length
        self.col_specs = col_specs

    def init_state(self, num_keys: int, device) -> dict:
        N = self.length

        def zero():
            return {k: torch.zeros((num_keys, N), dtype=to_torch_dtype(dt),
                                   device=device)
                    for k, dt in self.col_specs.items()}

        return {"cur": zero(), "prev": zero(),
                "cnt": torch.zeros((num_keys,), dtype=torch.int64, device=device),
                "prev_full": torch.zeros((num_keys,), dtype=torch.bool, device=device)}

    def apply(self, state, cols, ctx):
        N = self.length
        K = state["cnt"].shape[0]
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
        pk = torch.clamp(cols[PK_KEY].to(torch.int64), 0, K - 1)
        jN = torch.arange(N, dtype=torch.int64, device=dev)

        order, _inv, occ, counts, start_pos = _per_key_layout(pk, valid_cur, K)
        cnt0 = state["cnt"][pk]                  # [B] prior arrivals of row's key
        seq = cnt0 + occ                         # absolute per-key sequence
        flush = valid_cur & ((seq + 1) % N == 0)
        part_start = cnt0 - cnt0 % N             # partial batch's first seq

        def gather(q):
            """[B, N] rows at absolute positions q[b, j] of row b's key:
            from this chunk, the stored partial ring, or the stored
            previous batch (negative q = invalid)."""
            from_chunk = q >= cnt0[:, None]
            chunk_row = order[torch.clamp(start_pos[:, None] + (q - cnt0[:, None]),
                                          0, B - 1)]
            in_ring = (~from_chunk) & (q >= part_start[:, None])
            slot = q % N
            pkk = pk[:, None].expand(B, N)
            return {k: torch.where(from_chunk, cols[k][chunk_row],
                                   torch.where(in_ring, state["cur"][k][pkk, slot],
                                               state["prev"][k][pkk, slot]))
                    for k in keys}

        # batch being completed by a flush row at seq s: positions s+1-N..s
        cur_q = (seq[:, None] - (N - 1)) + jN[None, :]
        cur_rows = gather(cur_q)
        # the batch before it: positions s+1-2N..s-N (may be the stored prev)
        prev_q = cur_q - N
        prev_rows = gather(prev_q)
        prev_from_store = prev_q[:, 0] < part_start
        has_prev = flush & (prev_q[:, 0] >= 0) & (
            ~prev_from_store | state["prev_full"][pk])

        # ordering: per flush row r: N expired, 1 reset, N current
        idx = torch.arange(B, dtype=torch.int64, device=dev)
        STRIDE = 2 * N + 1
        exp_okey = (idx[:, None] * STRIDE + jN[None, :]).reshape(B * N)
        cur_okey = (idx[:, None] * STRIDE + N + 1 + jN[None, :]).reshape(B * N)
        prev_lane = has_prev[:, None].expand(B, N).reshape(B * N)
        exp_emit = {k: v.reshape(B * N) for k, v in prev_rows.items()}
        exp_emit[TS_KEY] = torch.where(prev_lane, now, exp_emit[TS_KEY])
        cur_emit = {k: v.reshape(B * N) for k, v in cur_rows.items()}
        reset_rows = _zero_rows(cols, B, dev)
        reset_rows[TS_KEY] = _full(B, now, torch.int64, dev)
        parts = [
            (exp_emit, _full(B * N, EXPIRED, torch.int8, dev), prev_lane, exp_okey),
            (reset_rows, _full(B, RESET, torch.int8, dev), has_prev, idx * STRIDE + N),
            (cur_emit, _full(B * N, CURRENT, torch.int8, dev),
             flush[:, None].expand(B, N).reshape(B * N), cur_okey),
        ]
        out, okey = _order_emit(parts)
        _with_okey(out, okey, cols)
        out[FLUSH_KEY] = torch.zeros_like(out[TS_KEY], dtype=torch.int32)

        # ---- state update
        new_cnt = state["cnt"] + counts
        part_start_new = (new_cnt - new_cnt % N)[pk]
        # prev batch: the last completed batch. Keys that flushed at least
        # once take a full new prev, whose rows may also come from the old
        # cur ring (a batch started before this chunk): built before the
        # cur ring is written
        flushed_key = _key_flags(flush, pk, K)
        in_prev = valid_cur & (seq >= part_start_new - N) & (seq < part_start_new)
        keep = valid_cur & (seq >= part_start_new)
        flat = pk * N + seq % N
        for k in list(state["prev"]):
            new_prev = torch.where(flushed_key[:, None], state["cur"][k],
                                   state["prev"][k])
            put_where_(new_prev.view(-1), 0, flat, cols[k], in_prev)
            state["prev"][k] = new_prev
            # cur ring: rows with seq >= floorN(new_cnt) of their key
            put_where_(state["cur"][k].view(-1), 0, flat, cols[k], keep)
        state["cnt"].copy_(new_cnt)
        state["prev_full"] |= flushed_key
        return state, out

    def contents(self, state):
        """Join/find probes see the last completed batch per key (the
        reference's ``expiredEventQueue``)."""
        N = self.length
        K = state["prev_full"].shape[0]
        return dict(state["prev"]), state["prev_full"][:, None].expand(K, N)

    def reset_keys(self, state, ids):
        state["cnt"].index_fill_(0, ids, 0)
        state["prev_full"].index_fill_(0, ids, False)
        return state


class KeyedTimeBatchWindowStage(WindowStage):
    """Tumbling time batches per partition key (reference
    TimeBatchWindowProcessor per partition instance): a key's first event
    starts its boundary clock; at each elapsed boundary the key's
    collected batch flushes [EXPIRED(prev), RESET, CURRENT(batch)].
    Flushes are checked once per chunk against the chunk clock (arriving
    rows join the flushing batch) and drained compacted: at most D due
    keys per tick, leftovers re-armed at once."""

    needs_scheduler = True

    keyed = True
    split_aware = True

    batch_mode = True

    def __init__(self, time_ms: int, col_specs: Dict[str, np.dtype], capacity: int,
                 expired_needed: bool = True):
        if time_ms <= 0:
            raise CompileError("timeBatch window needs a positive time")
        self.time_ms = time_ms
        self.capacity = capacity
        self.col_specs = col_specs
        # outputExpectsExpiredEvents=False: a key whose batch is empty
        # never flushes, so the findable prev batch is retained
        self.expired_needed = expired_needed

    def init_state(self, num_keys: int, device) -> dict:
        Wc = self.capacity

        def zero():
            return {k: torch.zeros((num_keys, Wc), dtype=to_torch_dtype(dt),
                                   device=device)
                    for k, dt in self.col_specs.items()}

        z32 = torch.zeros((num_keys,), dtype=torch.int32, device=device)
        return {"buf": zero(), "prev": zero(), "cnt": z32, "prev_cnt": z32.clone(),
                "next_emit": torch.zeros((num_keys,), dtype=torch.int64,
                                         device=device)}   # 0 = unstarted

    def apply(self, state, cols, ctx):
        Wc = self.capacity
        K = state["cnt"].shape[0]
        t = self.time_ms
        valid = cols[VALID_KEY]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
        pk = torch.clamp(cols[PK_KEY].to(torch.int64), 0, K - 1)
        jW = torch.arange(Wc, dtype=torch.int64, device=dev)
        buf, prev = state["buf"], state["prev"]
        cnt0 = state["cnt"].to(torch.int64)
        prev_cnt = state["prev_cnt"].to(torch.int64)

        # ---- collect arrivals (rows join the possibly-flushing batch)
        _o, _i, occ, counts, _s = _per_key_layout(pk, valid_cur, K)
        slot = torch.minimum(cnt0[pk] + occ, torch.full_like(occ, Wc - 1))
        for k, b in buf.items():
            put_where_(b.view(-1), 0, pk * Wc + slot, cols[k], valid_cur)
        overflow_now = cnt0 + counts
        cnt = torch.clamp(overflow_now, max=Wc)
        # first arrival starts the key's boundary clock
        ne0 = state["next_emit"]
        next_emit = torch.where((ne0 <= 0) & (counts > 0), now + t, ne0)

        # ---- compacted flush of due keys: the first D in (global) key
        # order; jD is a flushing key's place among them
        D = min(64, _global_capacity(ctx, K))
        due = (next_emit > 0) & (now >= next_emit) & (
            (cnt > 0) | (self.expired_needed & (prev_cnt > 0)))
        rank, n_due = _due_ranks(ctx, due)
        sel = due & (rank < D)
        Dl = min(D, K)
        kids = torch.argsort((~sel).to(torch.int8), stable=True)[:Dl]
        ksel = sel[kids]
        jD = rank[kids]
        cur_sel = (ksel[:, None] & (jW[None, :] < cnt[kids][:, None])).reshape(-1)
        prev_sel = (ksel[:, None] & (jW[None, :] < prev_cnt[kids][:, None])).reshape(-1)
        leftover = n_due > D

        STRIDE = 2 * Wc + 1
        jwl = jW[None, :].expand(Dl, Wc)
        prev_rows = {k: v[kids].reshape(Dl * Wc) for k, v in prev.items()}
        prev_rows[TS_KEY] = torch.where(prev_sel, now, prev_rows[TS_KEY])
        cur_rows = {k: v[kids].reshape(Dl * Wc) for k, v in buf.items()}
        reset_rows = _zero_rows(cur_rows, Dl, dev)
        reset_rows[TS_KEY] = _full(Dl, now, torch.int64, dev)
        parts = [
            (prev_rows, _full(Dl * Wc, EXPIRED, torch.int8, dev), prev_sel,
             (jD[:, None] * STRIDE + jwl).reshape(-1)),
            (reset_rows, _full(Dl, RESET, torch.int8, dev),
             ksel & (cnt[kids] > 0) & (prev_cnt[kids] > 0), jD * STRIDE + Wc),
            (cur_rows, _full(Dl * Wc, CURRENT, torch.int8, dev), cur_sel,
             (jD[:, None] * STRIDE + Wc + 1 + jwl).reshape(-1)),
        ]
        out, okey = _order_emit(parts)
        _with_okey(out, okey, cols)
        out[FLUSH_KEY] = torch.zeros_like(out[TS_KEY], dtype=torch.int32)

        # flushed keys: cur -> prev, roll the boundary past `now`
        fsel = _key_flags(ksel, kids, K)
        for k in list(prev):
            prev[k] = torch.where(fsel[:, None], buf[k], prev[k])
        new_prev_cnt = torch.where(fsel, cnt, prev_cnt)
        new_cnt = torch.where(fsel, 0, cnt)
        rolled = now - ((now - next_emit) % t) + t
        new_next = torch.where(fsel, rolled, next_emit)

        out[OVERFLOW_KEY] = (overflow_now > Wc).any().to(torch.int32)
        pending = (new_next > 0) & ((new_cnt > 0) | (
            self.expired_needed & (new_prev_cnt > 0)))
        nxt = torch.where(pending, new_next, _BIG).min()
        nxt = torch.where(leftover, now, nxt)
        out[NOTIFY_KEY] = torch.where(pending.any() | leftover, nxt, -1)
        state["cnt"].copy_(new_cnt)
        state["prev_cnt"].copy_(new_prev_cnt)
        state["next_emit"].copy_(new_next)
        return state, out

    def contents(self, state):
        """Join/find probes see the last flushed batch per key."""
        jW = torch.arange(self.capacity, dtype=torch.int32,
                          device=state["prev_cnt"].device)
        return dict(state["prev"]), jW[None, :] < state["prev_cnt"][:, None]

    def reset_keys(self, state, ids):
        for k in ("cnt", "prev_cnt", "next_emit"):
            state[k].index_fill_(0, ids, 0)
        return state


class KeyedSessionWindowStage(WindowStage):
    """``session(gap)`` over dense per-key state: a ``[K, W]`` row buffer,
    each key's last event time and row count. Events pass as CURRENT; a
    key's row arriving more than ``gap`` after the key's previous one
    first emits the buffered session as EXPIRED (ts = now), and a key idle
    past ``gap`` at the end of a step drains as EXPIRED (reference
    ``SessionWindowProcessor`` without allowedLatency), at most
    ``SWEEP_KEYS`` keys a step in key order, the rest re-armed at once.

    In-batch breaks come from a closed form: row i of key k breaks iff
    ts_i > prev_i + gap, prev_i being the previous same-key row's ts (the
    state's ``last`` for the key's first row, whose key must also hold a
    session). A break emits the session it ends: the key's held rows and
    its batch rows before i at its first break in the batch, else the
    batch rows since its previous break. A row's slot is its position in
    its session (the last slot when the buffer is full, which raises)."""

    needs_scheduler = True

    keyed = True
    split_aware = True

    SWEEP_KEYS = 128

    def __init__(self, gap_ms: int, col_specs: Dict[str, np.dtype], capacity: int):
        if gap_ms <= 0:
            raise CompileError("session window needs a positive gap")
        self.gap_ms = gap_ms
        self.capacity = capacity
        self.col_specs = col_specs

    def init_state(self, num_keys: int, device) -> dict:
        W = self.capacity
        return {
            "buf": {k: torch.zeros((num_keys, W), dtype=to_torch_dtype(dt),
                                   device=device)
                    for k, dt in self.col_specs.items()},
            "cnt": torch.zeros((num_keys,), dtype=torch.int32, device=device),
            "last": torch.zeros((num_keys,), dtype=torch.int64, device=device),
            "sess_overflow": torch.zeros((), dtype=torch.int32, device=device),
        }

    def apply(self, state, cols, ctx):
        if ctx.get("horizon") is not None:
            return self._sweep_chain(state, cols, ctx)
        W = self.capacity
        gap = self.gap_ms
        buf = state["buf"]
        cnt0 = state["cnt"].to(torch.int64)
        last0 = state["last"].clone()
        K = cnt0.shape[0]
        D = min(self.SWEEP_KEYS, _global_capacity(ctx, K))
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
        ts = cols[TS_KEY]
        pk = torch.clamp(cols[PK_KEY].to(torch.int64), 0, K - 1)
        sidx = torch.arange(B, dtype=torch.int64, device=dev)

        order, _inv, occ, counts, start_pos = _per_key_layout(pk, valid_cur, K)
        p = start_pos + occ                      # row's position, key-grouped
        prev_ts = torch.where(occ > 0, ts[order[torch.clamp(p - 1, min=0)]], last0[pk])
        brk = valid_cur & ((occ > 0) | (cnt0[pk] > 0)) & (ts > prev_ts + gap)
        # the last break at or before each grouped position
        lastb = torch.cummax(torch.where(brk[order], sidx, torch.full_like(sidx, -1)),
                             0).values

        def segment(at):
            """(first position, held rows before it) of the session holding
            grouped position ``at`` (the key's first session holds the
            state's rows too)."""
            lb = torch.where(at >= start_pos, lastb[torch.clamp(at, min=0)],
                             torch.full_like(at, -1))
            first = lb < start_pos
            return (torch.where(first, start_pos, lb),
                    torch.where(first, cnt0[pk], torch.zeros_like(lb)))

        begin, base = segment(p)
        q = base + (p - begin)                   # session size before row i joins
        # a break at i emits the session of position p - 1 (held rows only
        # at the key's first row)
        pbegin, pbase = segment(p - 1)
        c = pbase + (p - pbegin)
        e_cnt = torch.where(brk, torch.clamp(c, max=W), 0)

        # the state after the batch, for the idle sweep
        is_last = valid_cur & (occ + 1 == counts[pk])
        cnt_f = cnt0.clone()
        put_where_(cnt_f, 0, pk, q + 1, is_last)
        last_f = last0.clone()
        put_where_(last_f, 0, pk, ts, is_last)
        overflow = state["sess_overflow"] + (valid_cur & (q >= W)).sum().to(torch.int32)
        due = (cnt_f > 0) & (last_f + gap <= now)
        # a due key's place among every due key in (global) key order
        rank, n_due = _due_ranks(ctx, due)
        swept = due & (rank < D)
        s_cnt = torch.where(swept, torch.clamp(cnt_f, max=W), 0)
        n_b, n_s, n_due = torch.stack([e_cnt.sum(), s_cnt.sum(), n_due]).tolist()

        # the broken sessions' rows, read before the buffer is written: lane
        # j holds session position j (the last lane the latest position)
        bi, bj = _expand(e_cnt, n_b)
        qq = torch.where(bj < W - 1, bj, c[bi] - 1)
        from_ring = qq < pbase[bi]
        rslot = pk[bi] * W + torch.clamp(qq, max=W - 1)
        brow = order[torch.clamp(pbegin[bi] + (qq - pbase[bi]), 0, B - 1)]
        exp_rows = {n: torch.where(from_ring, b.view(-1)[rslot], cols[n][brow])
                    for n, b in buf.items()}
        exp_rows[TS_KEY] = _full(n_b, now, torch.int64, dev)

        # append every row at its session slot; of the rows sharing a slot
        # (later sessions of the batch, a full buffer) the latest wins
        flat_w = pk * W + torch.clamp(q, max=W - 1)
        tgt = torch.where(valid_cur, flat_w, torch.full_like(flat_w, K * W))
        latest = torch.full((K * W + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
            0, tgt, p, "amax")
        wr = valid_cur & (latest[tgt] == p)
        for n, b in buf.items():
            put_where_(b.view(-1), 0, flat_w, cols[n], wr)

        # end-of-batch idle sweep of the first D due keys
        sk, sj = _expand(s_cnt, n_s)
        sweep_rows = {n: b.view(-1)[sk * W + sj] for n, b in buf.items()}
        sweep_rows[TS_KEY] = _full(n_s, now, torch.int64, dev)

        STRIDE = W + 1
        parts = [
            (exp_rows, _full(n_b, EXPIRED, torch.int8, dev),
             torch.ones((n_b,), dtype=torch.bool, device=dev), bi * STRIDE + bj),
            ({k: cols[k] for k in keys}, cols[TYPE_KEY], valid_cur, sidx * STRIDE + W),
            (sweep_rows, _full(n_s, EXPIRED, torch.int8, dev),
             torch.ones((n_s,), dtype=torch.bool, device=dev),
             B * STRIDE + rank[sk] * W + sj),
        ]
        out, okey = _order_emit(parts)
        _with_okey(out, okey, cols)
        cnt_f = torch.where(swept, 0, cnt_f)
        live = cnt_f > 0
        if n_due > D:
            out[NOTIFY_KEY] = torch.full((), now, dtype=torch.int64, device=dev)
        else:
            out[NOTIFY_KEY] = torch.where(
                live.any(), torch.where(live, last_f + gap, _BIG).min(), -1)
        out[OVERFLOW_KEY] = (overflow > state["sess_overflow"]).to(torch.int32)
        state["cnt"].copy_(cnt_f.to(torch.int32))
        state["last"].copy_(last_f)
        state["sess_overflow"].copy_(overflow)
        return state, out

    def _sweep_chain(self, state, cols, ctx):
        """A TIMER step standing for the chain of timer steps up to
        ``ctx["horizon"]``: every key whose session ends by then drains at
        tick max(now, last + gap), the keys of a tick in key order,
        ``SWEEP_KEYS`` to a chain step (the reference re-arms at the same
        tick for the rest). ``CHUNK_KEY`` carries each row's chain step."""
        W = self.capacity
        gap = self.gap_ms
        buf = state["buf"]
        cnt0 = state["cnt"].to(torch.int64)
        last0 = state["last"]
        K = cnt0.shape[0]
        D = min(self.SWEEP_KEYS, K)
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        now = int(ctx["current_time"])
        live = cnt0 > 0
        tick = torch.clamp(last0 + gap, min=now)
        swept = live & (tick <= int(ctx["horizon"]))
        # the chain's layout over every key (every process's, under a
        # split: global key g = l * n + q of process q)
        tick_g = torch.where(swept, tick, _BIG)
        ks = ctx.get("key_split")
        if ks is not None:
            tick_g = torch.stack(ks.gather(tick_g)).t().reshape(-1)
            D = min(self.SWEEP_KEYS, ks.capacity(K))
        korder = torch.argsort(tick_g, stable=True)
        tick_s = tick_g[korder]
        swept_s = tick_s < _BIG
        pos = torch.arange(tick_g.shape[0], dtype=torch.int64, device=dev)
        new_tick = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                              tick_s[1:] != tick_s[:-1]])
        r = pos - torch.cummax(torch.where(new_tick, pos, torch.full_like(pos, -1)),
                               0).values
        step_s = torch.cumsum(((r % D) == 0) & swept_s, 0) - 1
        step = torch.empty_like(step_s)
        step[korder] = step_s
        lane = torch.empty_like(r)
        lane[korder] = r % D
        if ks is not None:
            mine = ks.keys(torch.arange(K, dtype=torch.int64, device=dev))
            step, lane = step[mine], lane[mine]
        s_cnt = torch.where(swept, torch.clamp(cnt0, max=W), 0)
        n_s = int(s_cnt.sum())
        sk, sj = _expand(s_cnt, n_s)
        rows = {n: b.view(-1)[sk * W + sj] for n, b in buf.items()}
        rows[TS_KEY] = tick[sk]
        span = D * W
        parts = [
            (rows, _full(n_s, EXPIRED, torch.int8, dev),
             torch.ones((n_s,), dtype=torch.bool, device=dev),
             step[sk] * span + lane[sk] * W + sj),
            ({k: cols[k] for k in keys}, cols[TYPE_KEY],
             valid & (cols[TYPE_KEY] == CURRENT),
             torch.full((B,), _BIG - 1, dtype=torch.int64, device=dev)),
        ]
        out, okey = _order_emit(parts)
        _with_okey(out, okey, cols)
        out[CHUNK_KEY] = torch.where(out[VALID_KEY], torch.div(
            okey, span, rounding_mode="floor"), -1)
        rest = live & ~swept
        out[NOTIFY_KEY] = torch.where(
            rest.any(), torch.where(rest, last0 + gap, _BIG).min(), -1)
        out[OVERFLOW_KEY] = torch.zeros((), dtype=torch.int32, device=dev)
        state["cnt"].copy_(torch.where(swept, 0, cnt0).to(torch.int32))
        return state, out

    def contents(self, state):
        jW = torch.arange(self.capacity, dtype=torch.int32, device=state["cnt"].device)
        return dict(state["buf"]), jW[None, :] < state["cnt"][:, None]

    def reset_keys(self, state, ids):
        state["cnt"].index_fill_(0, ids, 0)
        state["last"].index_fill_(0, ids, 0)
        return state


class KeyedHoppingWindowStage(WindowStage):
    """``hopping(windowTime, hopTime)`` per partition key: each key hops on
    its own phase (the reference gives every key its own
    HopingWindowProcessor whose first event arms the schedule); every hop
    emits the key's trailing windowTime of events as a batch
    [EXPIRED(prev snapshot), RESET, CURRENT(snapshot)]."""

    needs_scheduler = True

    keyed = True
    split_aware = True

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
        z = torch.zeros((num_keys,), dtype=torch.int64, device=device)
        return {"buf": _ring_buffers(self.col_specs, num_keys * Wc, device),
                "prev": _ring_buffers(self.col_specs, num_keys * Wc, device),
                "total": z, "expired_upto": z.clone(), "prev_count": z.clone(),
                "next_emit": torch.full((num_keys,), -1, dtype=torch.int64,
                                        device=device)}

    def apply(self, state, cols, ctx):
        Wc = self.capacity
        K = state["total"].shape[0]
        w, hop = self.window_ms, self.hop_ms
        valid = cols[VALID_KEY]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
        pk = torch.clamp(cols[PK_KEY].to(torch.int64), 0, K - 1)
        buf, prev = state["buf"], state["prev"]
        _order, _inv, occ_r, counts, _start = _per_key_layout(pk, valid_cur, K)

        # append arrivals to each key's ts-monotone FIFO ring
        total0 = state["total"].clone()
        exp0 = state["expired_upto"].clone()
        prev_count = state["prev_count"].clone()
        seq = total0[pk] + occ_r
        write = valid_cur & (occ_r >= counts[pk] - Wc)
        for k, b in buf.items():
            put_where_(b, 0, pk * Wc + seq % Wc, cols[k], write)
        total = total0 + counts

        # per-key hop schedule: a key's first event arms it
        ne0 = state["next_emit"]
        ne = torch.where((ne0 < 0) & (total > 0), now + hop, ne0)
        send = (ne >= 0) & (now >= ne)
        ne2 = torch.where(send, ne + hop, ne)

        # stale rows (older than the trailing window) leave the live range
        j = torch.arange(Wc, dtype=torch.int64, device=dev)[None, :]
        grid_k = torch.arange(K, dtype=torch.int64, device=dev)[:, None]
        fifo_seq = exp0[:, None] + j
        occ = fifo_seq < total[:, None]
        flat = (grid_k * Wc + fifo_seq % Wc).reshape(-1)
        ring_ts = buf[TS_KEY][flat].reshape(K, Wc)
        stale = occ & (ring_ts <= now - w)
        new_exp = exp0 + stale.sum(1)

        in_window = occ & ~stale & send[:, None]
        cur_rows = {k: v[flat] for k, v in buf.items()}
        n_emit = in_window.sum(1)

        # key-major emission order: [EXPIRED prev, RESET, CURRENT snapshot]
        STRIDE = 2 * Wc + 2
        kflat = grid_k.expand(K, Wc).reshape(-1)
        jflat = j.expand(K, Wc).reshape(-1)
        kglob = _global_keys(ctx, grid_k[:, 0])     # order keys: global key-major
        prev_valid = ((j < prev_count[:, None]) & send[:, None]).reshape(-1)
        prev_rows = dict(prev)
        prev_rows[TS_KEY] = torch.where(prev_valid, now, prev_rows[TS_KEY])
        reset_valid = send & (prev_count > 0)
        reset_rows = _zero_rows(buf, K, dev)
        reset_rows[TS_KEY] = torch.where(reset_valid, now, 0)
        parts = [
            (prev_rows, _full(K * Wc, EXPIRED, torch.int8, dev), prev_valid,
             kglob[kflat] * STRIDE + jflat),
            (reset_rows, _full(K, RESET, torch.int8, dev), reset_valid,
             kglob * STRIDE + Wc),
            (cur_rows, _full(K * Wc, CURRENT, torch.int8, dev),
             in_window.reshape(-1), kglob[kflat] * STRIDE + Wc + 1 + jflat),
        ]
        out, okey = _order_emit(parts)
        _with_okey(out, okey, cols)
        out[FLUSH_KEY] = torch.zeros_like(out[TS_KEY], dtype=torch.int32)

        # the emitted snapshot becomes each flushing key's next expiry batch
        emit_rank = torch.cumsum(in_window.to(torch.int64), 1) - 1
        pslot = (grid_k * Wc + emit_rank).reshape(-1)
        clear = send[kflat]
        for k in list(prev):
            base = torch.where(clear, torch.zeros((), dtype=prev[k].dtype, device=dev),
                               prev[k])
            put_where_(base, 0, pslot, cur_rows[k], in_window.reshape(-1))
            prev[k] = base
        state["total"].copy_(total)
        state["expired_upto"].copy_(new_exp)
        state["prev_count"].copy_(torch.where(send, n_emit, prev_count))
        state["next_emit"].copy_(ne2)
        pending = ne2 >= 0
        out[NOTIFY_KEY] = torch.where(pending.any(),
                                      torch.where(pending, ne2, _BIG).min(), -1)
        out[OVERFLOW_KEY] = ((total - new_exp) > Wc).any().to(torch.int32)
        return state, out

    def contents(self, state):
        Wc = self.capacity
        K = state["total"].shape[0]
        dev = state["total"].device
        j = torch.arange(Wc, dtype=torch.int64, device=dev)[None, :]
        fifo_seq = state["expired_upto"][:, None] + j
        occ = fifo_seq < state["total"][:, None]
        grid_k = torch.arange(K, dtype=torch.int64, device=dev)[:, None]
        flat = (grid_k * Wc + fifo_seq % Wc).reshape(-1)
        return {k: v[flat].reshape(K, Wc) for k, v in state["buf"].items()}, occ

    def reset_keys(self, state, ids):
        for k in ("total", "expired_upto", "prev_count"):
            state[k].index_fill_(0, ids, 0)
        state["next_emit"].index_fill_(0, ids, -1)
        return state


class KeyedBatchWindowStage(WindowStage):
    """``#window.batch()`` per partition key: key k's window is its rows
    from the latest chunk containing k; those rows expire when k's next
    chunk arrives (each key has its own BatchWindowProcessor instance in
    the reference partition runtime). Per key-in-chunk emission:
    [EXPIRED(prev batch), RESET, CURRENT rows], keys ordered by first
    appearance in the chunk."""

    keyed = True
    # its order keys are batch positions
    split_aware = True

    batch_mode = True

    def __init__(self, col_specs: Dict[str, np.dtype], capacity: int):
        self.col_specs = col_specs
        self.capacity = capacity

    def init_state(self, num_keys: int, device) -> dict:
        return {"prev": _ring_buffers(self.col_specs, num_keys * self.capacity, device),
                "prev_count": torch.zeros((num_keys,), dtype=torch.int64,
                                          device=device)}

    def apply(self, state, cols, ctx):
        Wc = self.capacity
        prev = state["prev"]
        prev_count = state["prev_count"].clone()
        K = prev_count.shape[0]
        keys = _data_keys(cols)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        dev = valid.device
        now = int(ctx["current_time"])
        valid_cur = valid & (cols[TYPE_KEY] == CURRENT)
        pk = torch.clamp(cols[PK_KEY].to(torch.int64), 0, K - 1)
        B_idx = torch.arange(B, dtype=torch.int64, device=dev)

        _order, _inv, occ, counts, _start = _per_key_layout(pk, valid_cur, K)
        in_chunk = counts > 0
        # anchor: each key's first row index this chunk
        first_row = torch.full((K + 1,), B, dtype=torch.int64, device=dev).scatter_reduce(
            0, torch.where(valid_cur, pk, K), B_idx, "amin")[:K]

        STRIDE = Wc + B + 2
        grid_k = torch.arange(K, dtype=torch.int64, device=dev)[:, None].expand(K, Wc)
        widx = torch.arange(Wc, dtype=torch.int64, device=dev)[None, :].expand(K, Wc)
        prev_valid = ((widx < prev_count[:, None]) & in_chunk[:, None]).reshape(-1)
        prev_rows = dict(prev)
        prev_rows[TS_KEY] = torch.where(prev_valid, now, prev_rows[TS_KEY])
        reset_valid = in_chunk & (prev_count > 0)
        reset_rows = _zero_rows(prev, K, dev)
        reset_rows[TS_KEY] = torch.where(reset_valid, now, 0)
        parts = [
            (prev_rows, _full(K * Wc, EXPIRED, torch.int8, dev), prev_valid,
             first_row[grid_k.reshape(-1)] * STRIDE + widx.reshape(-1)),
            (reset_rows, _full(K, RESET, torch.int8, dev), reset_valid,
             first_row * STRIDE + Wc),
            ({k: cols[k] for k in keys}, cols[TYPE_KEY], valid_cur,
             first_row[pk] * STRIDE + Wc + 1 + B_idx),
        ]
        out, okey = _order_emit(parts)
        _with_okey(out, okey, cols)
        out[FLUSH_KEY] = torch.zeros_like(out[TS_KEY], dtype=torch.int32)

        clear = in_chunk[grid_k.reshape(-1)]   # wipe only keys in this chunk
        for k in list(prev):
            base = torch.where(clear, torch.zeros((), dtype=prev[k].dtype, device=dev),
                               prev[k])
            put_where_(base, 0, pk * Wc + occ, cols[k], valid_cur & (occ < Wc))
            prev[k] = base
        state["prev_count"].copy_(torch.where(in_chunk, counts, prev_count))
        out[OVERFLOW_KEY] = (counts > Wc).any().to(torch.int32)
        return state, out

    def contents(self, state):
        Wc = self.capacity
        K = state["prev_count"].shape[0]
        cols = {k: v.reshape(K, Wc) for k, v in state["prev"].items()}
        j = torch.arange(Wc, dtype=torch.int64, device=state["prev_count"].device)[None, :]
        return cols, j < torch.clamp(state["prev_count"], max=Wc)[:, None]

    def reset_keys(self, state, ids):
        state["prev_count"].index_fill_(0, ids, 0)
        return state


def create_keyed_window_stage(window, input_def, resolver, app_context,
                              expired_needed: bool = True) -> WindowStage:
    """Keyed (partitioned) window factory, the reference's: capacity per
    key comes from ``app_context.partition_window_capacity`` (256 by
    default); the map and comparator windows (and session with its own key
    or allowedLatency) run on the host, one stage instance per key."""
    from siddhi_tpu_torch.ops.windows import (
        _const_param, _expect_arity, _int_const_param, window_col_specs)

    name = window.name.lower()
    col_specs = window_col_specs(input_def, extra=(PK_KEY,))
    capacity = getattr(app_context, "partition_window_capacity", 256)

    if name == "length":
        _expect_arity(window, 1, 1)
        return KeyedLengthWindowStage(_int_const_param(window, 0, "length"), col_specs)
    if name == "time":
        _expect_arity(window, 1, 1)
        return KeyedTimeWindowStage(_int_const_param(window, 0, "time"), col_specs, capacity)
    if name == "externaltime":
        # externalTime(tsAttr, time): per-key cutoff clock from the named
        # timestamp attribute
        from siddhi_tpu_torch.ops.windows import _external_ts_key

        _expect_arity(window, 2, 2)
        return KeyedTimeWindowStage(_int_const_param(window, 1, "time"),
                                    col_specs, capacity, external=True,
                                    ts_key=_external_ts_key(window, input_def))
    if name == "timelength":
        _expect_arity(window, 2, 2)
        return KeyedTimeWindowStage(_int_const_param(window, 0, "time"),
                                    col_specs, capacity,
                                    max_len=_int_const_param(window, 1, "length"))
    if name == "delay":
        # delay is key-independent: the unkeyed stage (its ring carries the
        # pk column) behaves identically per key
        from siddhi_tpu_torch.ops.windows import DelayWindowStage

        _expect_arity(window, 1, 1)
        return DelayWindowStage(_int_const_param(window, 0, "delay"),
                                col_specs,
                                getattr(app_context, "window_capacity", 4096))
    if name == "lengthbatch":
        if len(window.parameters) > 1:
            raise CompileError(
                "lengthBatch streamCurrentEvents is not supported inside a "
                "partition yet")
        _expect_arity(window, 1, 1)
        length = _int_const_param(window, 0, "length")
        if length == 0:
            raise CompileError(
                "lengthBatch(0) is not supported inside a partition yet")
        return KeyedLengthBatchWindowStage(length, col_specs)
    if name == "timebatch":
        if len(window.parameters) > 1:
            raise CompileError(
                "timeBatch startTime/streamCurrentEvents are not supported "
                "inside a partition yet")
        _expect_arity(window, 1, 1)
        return KeyedTimeBatchWindowStage(
            _int_const_param(window, 0, "time"), col_specs, capacity,
            expired_needed=expired_needed)
    if name == "batch":
        if window.parameters:
            raise CompileError(
                "batch chunkLength is not supported inside a partition yet")
        return KeyedBatchWindowStage(col_specs, capacity)
    if name == "hopping":
        _expect_arity(window, 2, 2)
        return KeyedHoppingWindowStage(
            _int_const_param(window, 0, "windowTime"),
            _int_const_param(window, 1, "hopTime"), col_specs, capacity)
    if name in ("session", "sort", "frequent", "lossyfrequent", "cron",
                "expression", "expressionbatch"):
        if name == "session" and len(window.parameters) < 2:
            # the plain session(gap), keyed by the partition, on the card
            return KeyedSessionWindowStage(int(_const_param(window, 0, "gap")),
                                           col_specs, capacity)
        # host-mode windows inside a partition (and session with its own key
        # and/or allowedLatency, whose key may differ from the partition
        # key): one stage instance per key
        from siddhi_tpu_torch.ops.host_windows import (
            PartitionedHostWindow, create_host_window_stage)

        return PartitionedHostWindow(
            lambda: create_host_window_stage(window, input_def, resolver,
                                             app_context))
    raise CompileError(
        f"window '{window.name}' inside a partition is not implemented yet "
        f"(keyed variants exist for: length, lengthBatch, time, timeBatch, "
        f"externalTime, timeLength, delay, session)"
    )
