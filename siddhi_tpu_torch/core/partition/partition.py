"""Partition keyers: host-side partition-key evaluation.

The counterpart of reference ``partition/PartitionStreamReceiver.java:96-135``
+ ``partition/executor/{Value,Range}PartitionExecutor.java`` — but instead of
routing events into per-key inner junction instances, rows get a dense
partition-key id column (``PK_KEY``) and all keys are processed by one device
step over ``[K, ...]`` state (see ``ops/keyed_windows.py``).

Counterpart of ``siddhi_tpu/core/partition/partition.py`` (host numpy,
copied). Range partitions are not ported yet.

Reference semantics preserved:
- value partition: key = value of the expression; a null key drops the event
  (``ValuePartitionExecutor.execute`` returns null on NPE and the chunked
  receive path skips null keys).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.core.event import CURRENT, encode_key_tuples
from siddhi_tpu_torch.ops.expressions import NUMPY_XP, TYPE_KEY, VALID_KEY
from siddhi_tpu_torch.query_api.definitions import AttrType


class PartitionKeySpace:
    """Shared partition-key dictionary: key tuple -> dense id. One per
    partition block — two streams partitioned by equal values land in the
    same partition instance (reference keys are strings compared across
    streams). Ids freed by the reference's ``@purge`` arrive in carried
    state as a free list and are reused first."""

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

    def __len__(self):
        # capacity semantics: freed slots still occupy the dense range
        return len(self._reverse)

    def snapshot(self) -> dict:
        with self._lock:
            return {"map": dict(self._map), "free": list(self._free),
                    "n": len(self._reverse)}

    def restore(self, snap: dict):
        with self._lock:
            self._map = dict(snap["map"])
            n = snap.get("n", len(self._map))
            self._reverse = [None] * n
            for k, i in self._map.items():
                self._reverse[i] = k
            self._free = list(snap.get("free", []))
            self._lut.fill(-1)  # raw-key bindings may have changed


class ValuePartitionKeyer:
    """``partition with (expr of Stream)``: tuple of expression values ->
    dense pk id via the partition's shared key space."""

    def __init__(self, fns: List[Tuple[Callable, AttrType]], keyspace: PartitionKeySpace):
        self._fns = fns
        self._keyspace = keyspace

    def __len__(self):
        return max(len(self._keyspace), 1)

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
        if drop.any():
            cols = dict(cols)
            cols[VALID_KEY] = valid & ~drop
        return cols, pk


class PartitionContext:
    """Planning context for one ``partition ... begin ... end`` block:
    the per-stream keyers over one shared key space."""

    def __init__(self, index: int):
        self.index = index
        self.keyspace = PartitionKeySpace()
        self.keyers: Dict[str, object] = {}      # outer stream id -> keyer

    def num_keys(self) -> int:
        return max(len(self.keyspace), 1)
