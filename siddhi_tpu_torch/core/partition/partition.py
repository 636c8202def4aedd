"""Partition keyers: host-side partition-key evaluation.

The counterpart of reference ``partition/PartitionStreamReceiver.java:96-135``
+ ``partition/executor/{Value,Range}PartitionExecutor.java`` — but instead of
routing events into per-key inner junction instances, rows get a dense
partition-key id column (``PK_KEY``) and all keys are processed by one device
step over ``[K, ...]`` state (see ``ops/keyed_windows.py``).

Counterpart of ``siddhi_tpu/core/partition/partition.py`` (host numpy,
copied).

Reference semantics preserved:
- value partition: key = value of the expression; a null key drops the event
  (``ValuePartitionExecutor.execute`` returns null on NPE and the chunked
  receive path skips null keys);
- range partition: one copy of the event per matching range condition, in
  range-declaration order; events matching no range are dropped;
- ``@purge``: keys idle past ``idle.period`` (wall clock) are retired, their
  dense state rows reset in every query of the block, and their ids reused.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.core.event import CURRENT, _pad_len, encode_key_tuples
from siddhi_tpu_torch.ops.expressions import NUMPY_XP, TYPE_KEY, VALID_KEY
from siddhi_tpu_torch.query_api.definitions import AttrType


class PartitionKeySpace:
    """Shared partition-key dictionary: key tuple -> dense id. One per
    partition block — two streams partitioned by equal values land in the
    same partition instance (reference keys are strings compared across
    streams). ``@purge`` retires idle ids into a free list for reuse
    (reference PartitionRuntimeImpl idle-partition purge)."""

    _LUT_MAX = 1 << 22  # raw-key bound for the vectorized table (4 M ids)

    def __init__(self):
        import threading

        self._lock = threading.RLock()
        self._map: Dict[tuple, int] = {}
        self._reverse: List[tuple] = []
        self._free: List[int] = []
        # single-int-key fast table: raw value (dictionary-encoded string
        # id or int key) -> dense pk; -1 = unseen. Steady state keys a
        # whole batch with ONE np.take instead of a per-row Python probe
        # (the partitioned-NFA host bottleneck — PERF.md round 5)
        self._lut = np.full(1024, -1, np.int32)
        # last-seen tracking is enabled only when the partition has @purge
        # (a per-batch touch would otherwise tax every partitioned app)
        self.last_seen: Optional[Dict[int, int]] = None

    def ids_of_ints(self, raw: np.ndarray) -> Optional[np.ndarray]:
        """Vectorized ``id_of`` over a single-int-key batch; None when the
        values fall outside the table's domain (negative / huge)."""
        if raw.size == 0:
            return np.empty(0, np.int32)
        vmin, vmax = int(raw.min()), int(raw.max())
        if vmin < 0 or vmax >= self._LUT_MAX:
            return None
        with self._lock:
            lut = self._lut
            if vmax >= lut.shape[0]:
                n = lut.shape[0]
                while n <= vmax:
                    n *= 2
                grown = np.full(n, -1, np.int32)
                grown[: lut.shape[0]] = lut
                self._lut = lut = grown
            out = lut[raw]
            miss = out < 0
            if miss.any():
                for x in np.unique(raw[miss]):
                    lut[int(x)] = self.id_of((int(x),))
                out = lut[raw]
        return out

    def enable_purge_tracking(self):
        if self.last_seen is None:
            self.last_seen = {}

    def id_of(self, key: tuple) -> int:
        with self._lock:
            i = self._map.get(key)
            if i is None:
                if self._free:
                    i = self._free.pop()
                    self._reverse[i] = key
                else:
                    i = len(self._reverse)
                    self._reverse.append(key)
                self._map[key] = i
            return i

    def touch(self, ids, now_ms: int):
        if self.last_seen is None:
            return
        with self._lock:
            for i in np.unique(np.asarray(ids)):
                self.last_seen[int(i)] = now_ms

    def retire_idle(self, now_ms: int, idle_ms: int) -> List[int]:
        """Unmap keys idle past ``idle_ms``. Their ids are NOT freed yet:
        the caller resets the ids' state rows first, then ``release``s
        them; in between the ids are unreachable (not in the map, not in
        the free list), so concurrent ingest cannot be wiped."""
        if self.last_seen is None:
            return []
        with self._lock:
            retired = []
            for i, t in list(self.last_seen.items()):
                if now_ms - t > idle_ms and i < len(self._reverse) \
                        and self._reverse[i] is not None:
                    self._map.pop(self._reverse[i], None)
                    self._reverse[i] = None
                    del self.last_seen[i]
                    retired.append(i)
            if retired:
                self._lut.fill(-1)  # retired raw keys must re-probe
            return retired

    def release(self, ids: List[int]):
        with self._lock:
            self._free.extend(ids)

    def __len__(self):
        # capacity semantics: freed slots still occupy the dense range
        return len(self._reverse)

    def snapshot(self) -> dict:
        with self._lock:
            return {"map": dict(self._map), "free": list(self._free),
                    "n": len(self._reverse)}

    def restore(self, snap: dict):
        import time as _time

        with self._lock:
            self._map = dict(snap["map"])
            n = snap.get("n", len(self._map))
            self._reverse = [None] * n
            for k, i in self._map.items():
                self._reverse[i] = k
            self._free = list(snap.get("free", []))
            self._lut.fill(-1)  # raw-key bindings may have changed
            if self.last_seen is not None:
                # restored keys start their idle clocks at restore time:
                # otherwise pre-restart keys would be invisible to purge
                now = int(_time.time() * 1000)
                self.last_seen = {i: now for i in self._map.values()}


class ValuePartitionKeyer:
    """``partition with (expr of Stream)``: tuple of expression values ->
    dense pk id via the partition's shared key space."""

    def __init__(self, fns: List[Tuple[Callable, AttrType]], keyspace: PartitionKeySpace):
        self._fns = fns
        self._keyspace = keyspace

    def __len__(self):
        return max(len(self._keyspace), 1)

    @property
    def static_keys(self) -> Optional[int]:
        return None  # dynamic key space

    def apply(self, cols: Dict[str, np.ndarray]):
        """Returns (cols, pk_ids). Null-key CURRENT rows are invalidated;
        non-CURRENT rows (TIMER) pass through with pk 0."""
        ctx = {"xp": NUMPY_XP}
        valid = cols[VALID_KEY]
        is_cur = valid & (cols[TYPE_KEY] == CURRENT)
        B = valid.shape[0]
        pk = np.zeros(B, np.int32)
        vals = []
        drop = np.zeros(B, bool)
        for fn, _t in self._fns:
            v, m = fn(cols, ctx)
            vals.append(np.broadcast_to(np.asarray(v), (B,)))
            if m is not None:
                drop |= np.broadcast_to(np.asarray(m), (B,)) & is_cur
        keyed = np.nonzero(is_cur & ~drop)[0]
        if keyed.size:
            got = None
            if len(vals) == 1 and vals[0].dtype.kind in "iu":
                # single int key (dictionary-encoded strings included):
                # one np.take through the keyspace table in steady state
                got = self._keyspace.ids_of_ints(
                    np.ascontiguousarray(vals[0][keyed]).astype(np.int64))
            if got is not None:
                pk[keyed] = got
            else:
                # vectorized dictionary encoding (shared helper — unique the
                # key tuples once, probe the Python keyspace only per unique)
                pk[keyed] = encode_key_tuples(vals, keyed, self._keyspace.id_of)
            if self._keyspace.last_seen is not None:
                import time as _time

                self._keyspace.touch(pk[keyed], int(_time.time() * 1000))
        if drop.any():
            cols = dict(cols)
            cols[VALID_KEY] = valid & ~drop
        return cols, pk


class RangePartitionKeyer:
    """``partition with (cond as 'label' or ... of Stream)``: pk id = range
    index (static key space). Rows are duplicated per matching range."""

    def __init__(self, conditions: List[Tuple[str, Callable]]):
        self._conditions = conditions  # [(label, condition fn)]
        # highest range id a keyed event has actually hit + 1: range
        # instances are lazily created too (reference initPartition), so
        # only instances this watermark covers may receive global-side
        # broadcast events
        self.seen_keys = 0

    def __len__(self):
        return len(self._conditions)

    @property
    def static_keys(self) -> Optional[int]:
        return len(self._conditions)

    def apply(self, cols: Dict[str, np.ndarray]):
        """Expand rows: a CURRENT row matching R ranges becomes R rows (in
        range order, reference PartitionStreamReceiver copy loop); rows
        matching none are dropped. TIMER/other rows are kept once (pk 0).
        The expanded batch is padded to a power of two, as the reference
        pads it."""
        ctx = {"xp": NUMPY_XP}
        valid = np.asarray(cols[VALID_KEY])
        is_cur = valid & (np.asarray(cols[TYPE_KEY]) == CURRENT)
        B = valid.shape[0]
        masks = np.zeros((B, len(self._conditions)), bool)
        for r, (_label, fn) in enumerate(self._conditions):
            masks[:, r] = np.asarray(fn(cols, ctx)) & is_cur
        keep_once = valid & ~is_cur  # TIMER etc.: not range-matched

        rows_cur, rngs = np.nonzero(masks)          # row-major: event order kept
        if rngs.size:
            self.seen_keys = max(self.seen_keys, int(rngs.max()) + 1)
        rows_other = np.nonzero(keep_once)[0]
        rows = np.concatenate([rows_cur, rows_other])
        pk_out = np.concatenate([rngs, np.zeros(len(rows_other), np.int64)]).astype(np.int32)
        order = np.argsort(rows, kind="stable")
        rows, pk_out = rows[order], pk_out[order]

        n = len(rows)
        cap = _pad_len(max(n, 1))
        out: Dict[str, np.ndarray] = {}
        for k in list(cols.keys()):
            v = np.asarray(cols[k])
            arr = np.zeros(cap, v.dtype)
            arr[:n] = v[rows]
            out[k] = arr
        out[VALID_KEY] = np.zeros(cap, bool)
        out[VALID_KEY][:n] = True  # selected rows are valid by construction
        pk = np.zeros(cap, np.int32)
        pk[:n] = pk_out
        return out, pk


class PartitionContext:
    """Planning context for one ``partition ... begin ... end`` block:
    the per-stream keyers plus the partition's inner-stream ('#stream')
    definitions and junctions (reference PartitionRuntimeImpl holds inner
    junctions per partition, here one junction whose rows carry pk ids),
    the streams one query of the block produces and another consumes,
    the ``@purge`` settings and the block's query runtimes."""

    def __init__(self, index: int):
        self.index = index
        self.keyspace = PartitionKeySpace()
        self.keyers: Dict[str, object] = {}      # outer stream id -> keyer
        self.inner_definitions: Dict[str, object] = {}   # '#X' -> StreamDefinition
        self.inner_junctions: Dict[str, object] = {}     # '#X' -> StreamJunction
        self.local_streams: set = set()
        # @purge config + the block's query runtimes (wired by app_runtime)
        self.purge_interval_ms: Optional[int] = None
        self.purge_idle_ms: Optional[int] = None
        self.runtimes: List[object] = []

    def num_keys(self) -> int:
        static = [k.static_keys for k in self.keyers.values() if k.static_keys]
        return max(max(static, default=0), len(self.keyspace), 1)

    def active_keys(self) -> int:
        """Keys whose instances actually exist (no 1-floor, no static
        floor): range keyers report their seen-id watermark, value keyers
        the allocated keyspace."""
        seen = [getattr(k, "seen_keys", 0) for k in self.keyers.values()]
        return max(max(seen, default=0), len(self.keyspace))

    def purge(self, now_ms: Optional[int] = None) -> List[int]:
        """Retire idle partition keys, reset their dense state rows in
        every query runtime of this block, then release the ids for reuse
        (reference @purge idle-partition eviction). Idle comparison uses
        the wall clock (touch() stamps wall time): the scheduler's
        event-time tick is ignored on purpose (playback apps mix clocks)."""
        import time as _time

        if now_ms is None:
            now_ms = int(_time.time() * 1000)
        idle = self.purge_idle_ms if self.purge_idle_ms is not None else 3600_000
        retired = self.keyspace.retire_idle(now_ms, idle)
        if retired:
            for rt in self.runtimes:
                rt.reset_partition_keys(retired)
            self.keyspace.release(retired)
        return retired
