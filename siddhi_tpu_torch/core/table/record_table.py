"""External-store table SPI and its caching front.

Counterpart of ``siddhi_tpu/core/table/record_table.py``, the mirror of
reference ``table/record/AbstractRecordTable.java`` (the SPI that store
extensions implement) and ``table/CacheTable*.java`` (FIFO/LRU/LFU caches
in front of a slow store). The engine pulls the store's rows into a
columnar probe surface and evaluates its compiled conditions as masked
broadcast compares, so a store needs add/read/delete/update only, no
condition language.

Register an implementation with ``SiddhiManager.set_extension(
'store:<type>', cls)`` and attach it with ``@store(type='<type>', ...)`` on
a table definition; ``@cache(size='N', cache.policy='FIFO|LRU|LFU')``
inside ``@store`` adds a bounded read cache.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.event import HostBatch
from siddhi_tpu_torch.core.table.in_memory_table import (
    EV_PREFIX, TBL_PREFIX, host, insert_rows)
from siddhi_tpu_torch.ops.expressions import NUMPY_XP, TS_KEY, TYPE_KEY, VALID_KEY
from siddhi_tpu_torch.query_api.definitions import AttrType, TableDefinition


class RecordTable:
    """External store SPI (reference AbstractRecordTable). Rows are plain
    lists in attribute order; string attributes arrive as Python strings."""

    def init(self, definition: TableDefinition, options: Dict[str, str]) -> None:
        self.definition = definition
        self.options = options

    def connect(self) -> None:
        pass

    def add(self, records: List[list]) -> None:
        raise NotImplementedError

    def read(self) -> List[list]:
        """Full scan: the engine filters and joins columnar-side."""
        raise NotImplementedError

    def delete(self, indices: List[int]) -> None:
        """Delete rows by their position in the last read()."""
        raise NotImplementedError

    def update(self, indices: List[int], rows: List[list]) -> None:
        raise NotImplementedError

    def disconnect(self) -> None:
        pass


class InMemoryRecordTable(RecordTable):
    """Reference implementation of the SPI (and the test double)."""

    def init(self, definition, options):
        super().init(definition, options)
        self.rows: List[list] = []

    def add(self, records):
        self.rows.extend([list(r) for r in records])

    def read(self):
        return [list(r) for r in self.rows]

    def delete(self, indices):
        for i in sorted(indices, reverse=True):
            del self.rows[i]

    def update(self, indices, rows):
        for i, r in zip(indices, rows):
            self.rows[i] = list(r)


class RowCache:
    """Bounded row cache with FIFO / LRU / LFU eviction (reference
    CacheTableFIFO / CacheTableLRU / CacheTableLFU) and optional
    retention-period expiry (reference ``util/cache/CacheExpirer.java``:
    a periodic sweep deletes rows older than ``retention.period``).
    ``now_fn`` is the app's event-aware clock."""

    def __init__(self, max_size: int, policy: str = "FIFO",
                 retention_ms: Optional[int] = None):
        policy = policy.upper()
        if policy not in ("FIFO", "LRU", "LFU"):
            raise ValueError(f"unknown cache policy '{policy}'")
        self.max_size = max_size
        self.policy = policy
        self.retention_ms = retention_ms
        self.purge_interval_ms = None  # sweep cadence (set by create_table)
        self.now_fn = None             # wired to the app clock at build
        self._rows: Dict[object, list] = {}
        self._order: List[object] = []        # FIFO/LRU order
        self._freq: Dict[object, int] = {}    # LFU
        self._added: Dict[object, int] = {}   # CACHE_TABLE_TIMESTAMP_ADDED

    def _now(self) -> int:
        if self.now_fn is not None:
            return int(self.now_fn())
        return int(time.time() * 1000)

    def __contains__(self, key):
        return key in self._rows

    def __len__(self):
        return len(self._rows)

    def get(self, key) -> Optional[list]:
        row = self._rows.get(key)
        if row is None:
            return None
        if (self.retention_ms is not None
                and self._now() - self._added.get(key, 0) > self.retention_ms):
            # an expired row not yet swept must not serve stale data
            self.drop(key)
            return None
        if self.policy == "LRU":
            self._order.remove(key)
            self._order.append(key)
        elif self.policy == "LFU":
            self._freq[key] = self._freq.get(key, 0) + 1
        return row

    def put(self, key, row: list):
        if key in self._rows:
            self._rows[key] = row
            self._added[key] = self._now()
            return
        while len(self._rows) >= self.max_size:
            self._evict_one()
        self._rows[key] = row
        self._order.append(key)
        self._freq[key] = 0
        self._added[key] = self._now()

    def expire(self, now_ms: Optional[int] = None) -> int:
        """Drop every row older than the retention period; returns how many
        (the CacheExpirer sweep)."""
        if self.retention_ms is None:
            return 0
        now = int(now_ms) if now_ms is not None else self._now()
        victims = [k for k, t in self._added.items()
                   if now - t > self.retention_ms]
        for k in victims:
            self.drop(k)
        return len(victims)

    def _evict_one(self):
        if self.policy in ("FIFO", "LRU"):
            victim = self._order.pop(0)
        else:  # LFU
            victim = min(self._order, key=lambda k: self._freq.get(k, 0))
            self._order.remove(victim)
        self._rows.pop(victim, None)
        self._freq.pop(victim, None)

    def drop(self, key):
        if key in self._rows:
            self._rows.pop(key)
            self._order.remove(key)
            self._freq.pop(key, None)
            self._added.pop(key, None)

    def keys(self):
        return list(self._order)


class RecordTableAdapter:
    """The engine-facing adapter: the surface of ``InMemoryTable``
    (contents/insert/delete/update/all_events) over a ``RecordTable``,
    with an optional primary-key row cache. Its contents are host arrays;
    a join step moves them to its device."""

    def __init__(self, record_table: RecordTable, definition: TableDefinition,
                 dictionary, cache: Optional[RowCache] = None,
                 primary_key: Optional[List[str]] = None):
        from siddhi_tpu_torch.ops.windows import window_col_specs

        self.record = record_table
        self.definition = definition
        self.dictionary = dictionary
        self.cache = cache
        self.primary_key = primary_key or []
        self._lock = threading.RLock()
        self.col_specs = window_col_specs(definition)

    # ------------------------------------------------------------ row codec

    def _encode_rows(self, rows: List[list]) -> Tuple[dict, np.ndarray]:
        from siddhi_tpu_torch.ops.types import dtype_of

        n = len(rows)
        cap = max(n, 1)
        cols = {TS_KEY: np.zeros(cap, np.int64),
                TYPE_KEY: np.zeros(cap, np.int8),
                VALID_KEY: np.zeros(cap, bool)}
        cols[VALID_KEY][:n] = True
        for pos, attr in enumerate(self.definition.attributes):
            arr = np.zeros(cap, dtype_of(attr.type))
            mask = np.zeros(cap, bool)
            for i, r in enumerate(rows):
                v = r[pos]
                if v is None:
                    mask[i] = True
                elif attr.type == AttrType.STRING:
                    arr[i] = self.dictionary.encode(v)
                else:
                    arr[i] = v
            cols[attr.name] = arr
            cols[attr.name + "?"] = mask
        return cols, cols[VALID_KEY]

    def _decode_batch(self, batch: HostBatch) -> List[list]:
        hb = HostBatch({k: host(v) for k, v in batch.cols.items()})
        events = hb.to_events(
            [(a.name, a.type) for a in self.definition.attributes],
            self.dictionary)
        return [list(e.data) for e in events]

    def _pk_of(self, row: list):
        idx = [i for i, a in enumerate(self.definition.attributes)
               if a.name in self.primary_key]
        return tuple(row[i] for i in idx)

    # -------------------------------------------------------------- surface

    def contents(self):
        with self._lock:
            return self._encode_rows(self.record.read())

    @property
    def count(self) -> int:
        return len(self.record.read())

    def insert(self, batch: HostBatch):
        with self._lock:
            rows = self._decode_batch(batch)
            self.record.add(rows)
            if self.cache is not None and self.primary_key:
                for r in rows:
                    self.cache.put(self._pk_of(r), r)

    def find_by_pk(self, key: tuple) -> Optional[list]:
        """Cache-first primary-key lookup (reference CacheTable read path:
        a hit serves from memory, a miss loads from the store)."""
        with self._lock:
            if self.cache is not None:
                row = self.cache.get(tuple(key))
                if row is not None:
                    return row
            for r in self.record.read():
                if self._pk_of(r) == tuple(key):
                    if self.cache is not None:
                        self.cache.put(tuple(key), r)
                    return r
            return None

    def _eval_dict(self, cols, batch: Optional[HostBatch]):
        ev = {TBL_PREFIX + k: np.asarray(v)[None, :] for k, v in cols.items()}
        B = 1
        if batch is not None:
            B = batch.cols[VALID_KEY].shape[0]
            for k, v in batch.cols.items():
                ev[EV_PREFIX + k] = host(v)[:, None]
        ev[TS_KEY] = ev.get(EV_PREFIX + TS_KEY, np.zeros((B, 1), np.int64))
        return ev, B

    def _matching_indices(self, cond, batch: Optional[HostBatch]):
        cols, valid = self.contents()
        ev, B = self._eval_dict(cols, batch)
        C = valid.shape[0]
        m = (np.asarray(cond(ev, {"xp": NUMPY_XP})) if cond is not None
             else np.ones((B, C), bool))
        m = np.broadcast_to(m, (B, C)) & valid[None, :]
        if batch is not None:
            m = m & host(batch.cols[VALID_KEY]).astype(bool)[:, None]
        return np.nonzero(m.any(axis=0))[0].tolist()

    def delete(self, cond, batch: Optional[HostBatch]):
        with self._lock:
            idx = self._matching_indices(cond, batch)
            if self.cache is not None:
                rows = self.record.read()
                for i in idx:
                    self.cache.drop(self._pk_of(rows[i]))
            self.record.delete(idx)

    def update(self, cond, assignments, batch: Optional[HostBatch]):
        """Row-at-a-time SPI update: the matching rows are read again, the
        assignments evaluated with the batch's last valid event (the last
        event wins, in chunk order) and written back through the SPI.
        Returns a ``[1, 1]`` any-match flag."""
        with self._lock:
            idx = self._matching_indices(cond, batch)
            if not idx:
                return torch.zeros((1, 1), dtype=torch.bool)
            rows = self.record.read()
            cols, _valid = self._encode_rows(rows)
            ev = {TBL_PREFIX + k: v for k, v in cols.items()}
            if batch is not None:
                last = int(np.nonzero(host(batch.cols[VALID_KEY]))[0][-1])
                for k, v in batch.cols.items():
                    ev[EV_PREFIX + k] = host(v)[last: last + 1]
            ev[TS_KEY] = ev.get(EV_PREFIX + TS_KEY, np.zeros(1, np.int64))
            ctx = {"xp": NUMPY_XP}
            name_pos = {a.name: i for i, a in enumerate(self.definition.attributes)}
            new_rows = []
            for i in idx:
                row = list(rows[i])
                for col_name, fn, _t in assignments:
                    v, _mk = fn(ev, ctx)
                    v = np.asarray(v)
                    val = np.broadcast_to(v, cols[TS_KEY].shape)[i] if v.ndim else v
                    attr = self.definition.attributes[name_pos[col_name]]
                    if attr.type == AttrType.STRING:
                        val = self.dictionary.decode(int(val))
                    elif attr.type in (AttrType.INT, AttrType.LONG):
                        val = int(val)
                    else:
                        val = val.item() if hasattr(val, "item") else val
                    row[name_pos[col_name]] = val
                new_rows.append(row)
                if self.cache is not None:
                    self.cache.drop(self._pk_of(rows[i]))
            self.record.update(idx, new_rows)
            return torch.ones((1, 1), dtype=torch.bool)

    def update_or_insert(self, cond, assignments, batch: HostBatch,
                         insert_mapping=None):
        """Per event in order (reference UpdateOrInsertReducer): update
        the rows it matches, else insert it (each table attribute from its
        mapped event column, null where unmapped). The reference's adapter
        has no such method, so its `update or insert into` a @store table
        drops the events (ROADMAP C, R5)."""
        with self._lock:
            cols = {k: host(v) for k, v in batch.cols.items()}
            for i in np.nonzero(cols[VALID_KEY])[0]:
                row = {k: v[i: i + 1] for k, v in cols.items()}
                if bool(self.update(cond, assignments, HostBatch(row)).any()):
                    continue
                if insert_mapping is not None:
                    row = insert_rows(self.col_specs, row, insert_mapping)
                self.insert(HostBatch(row))

    def all_events(self):
        cols, valid = self.contents()
        cols[VALID_KEY] = valid
        cols[TYPE_KEY] = np.zeros(valid.shape[0], np.int8)
        return HostBatch(cols).to_events(
            [(a.name, a.type) for a in self.definition.attributes],
            self.dictionary)


def create_table(definition: TableDefinition, dictionary, extensions: Dict[str, type],
                 device):
    """Table factory: ``@store(type=...)`` resolves a RecordTable extension
    (with an optional ``@cache``); otherwise the in-memory table on
    ``device``."""
    from siddhi_tpu_torch.core.app_runtime import _parse_purge_time
    from siddhi_tpu_torch.core.table.in_memory_table import InMemoryTable
    from siddhi_tpu_torch.ops.expressions import resolve_in
    from siddhi_tpu_torch.query_api.annotations import find_annotation

    store_ann = find_annotation(definition.annotations or [], "store")
    if store_ann is None:
        return InMemoryTable(definition, dictionary, device)
    opts = {k: v for k, v in store_ann.elements if k is not None}
    type_name = (opts.pop("type", None) or "").lower()
    cls = resolve_in(extensions, "store", type_name)
    if cls is None and type_name in ("inmemory", "memory"):
        cls = InMemoryRecordTable
    if cls is None:
        raise ValueError(f"unknown @store type '{type_name}'")
    record = cls()
    record.init(definition, opts)
    record.connect()

    pk_ann = find_annotation(definition.annotations or [], "primaryKey")
    primary_key = [v for _k, v in pk_ann.elements if v] if pk_ann else []

    cache = None
    cache_ann = store_ann.annotation("cache")
    if cache_ann is not None:
        copts = {k: v for k, v in cache_ann.elements if k is not None}
        size = int(copts.get("size", copts.get("max.size", 128)))
        policy = copts.get("cache.policy", copts.get("policy", "FIFO"))
        retention = copts.get("retention.period")
        retention_ms = purge_interval_ms = None
        if retention is not None:
            # AbstractQueryableRecordTable.java:156-163: a retention period
            # implies expiry; purge.interval defaults to the period itself
            retention_ms = _parse_purge_time(retention)
            purge_interval_ms = _parse_purge_time(
                copts.get("purge.interval", retention))
        cache = RowCache(size, policy, retention_ms=retention_ms)
        cache.purge_interval_ms = purge_interval_ms
    return RecordTableAdapter(record, definition, dictionary, cache=cache,
                              primary_key=primary_key)
