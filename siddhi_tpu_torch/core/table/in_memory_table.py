"""In-memory table: a columnar store on the app's device.

Counterpart of ``siddhi_tpu/core/table/in_memory_table.py``, which
replaces the reference's ``InMemoryTable`` + ``IndexEventHolder`` (hash
primary-key map, per-attribute TreeMap indexes, compiled
``CollectionExecutor`` scans) with one dense ``[C]`` column set and an
occupancy mask ``valid``: every lookup, update and delete evaluates its
compiled condition as a masked ``[B, C]`` broadcast compare. Rows insert
into the free slots in slot order; capacity doubles by a prefix copy when
the table is full.

``@primaryKey`` adds uniqueness and a host hash probe; ``@index`` adds
equality probes: host value -> slots maps for on-demand queries
(``index_candidates``), and a sorted-column ``searchsorted`` in the join
step (``core/query/join_runtime.py``). Both host maps are rebuilt only
when a mutation has marked them dirty.

Each mutation builds new column tensors (the reference rebuilds its
arrays the same way), so a ``contents()`` view taken before a mutation
keeps the rows it saw. The insert-only op log of the reference
(``incremental_snapshot``/``apply_increment``) waits for persistence.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.event import Event, HostBatch, StringDictionary
from siddhi_tpu_torch.ops.expressions import (
    TS_KEY, TYPE_KEY, VALID_KEY, ColumnRef, CompileError, Resolver, TorchXP)
from siddhi_tpu_torch.ops.scatter import put_where_
from siddhi_tpu_torch.ops.types import to_torch_dtype
from siddhi_tpu_torch.query_api.definitions import TableDefinition
from siddhi_tpu_torch.query_api.expressions import Variable

TBL_PREFIX = "t__"
EV_PREFIX = "s__"


def host(v) -> np.ndarray:
    """A tensor or array as numpy (one device read for a CUDA tensor)."""
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


def to_device(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    a = np.ascontiguousarray(v)
    if not a.flags.writeable:     # a wire frame's read-only view
        a = a.copy()
    return torch.from_numpy(a).to(device)


def insert_rows(col_specs: dict, rows: dict, insert_mapping) -> dict:
    """The table rows that unmatched `update or insert` events insert:
    each table attribute from its mapped event column (null where the
    mapping has none)."""
    n = rows[VALID_KEY].shape[0]
    ins = {TS_KEY: rows[TS_KEY],
           TYPE_KEY: rows.get(TYPE_KEY, np.zeros(n, np.int8)),
           VALID_KEY: np.ones(n, bool)}
    for table_attr, ev_col in insert_mapping:
        if ev_col is None:
            # a partial upsert output set inserts null
            ins[table_attr] = np.zeros(n, col_specs[table_attr])
            ins[table_attr + "?"] = np.ones(n, bool)
            continue
        ins[table_attr] = rows[ev_col]
        ins[table_attr + "?"] = rows.get(ev_col + "?", np.zeros(n, bool))
    return ins


class TableConditionResolver(Resolver):
    """Resolve an `on` condition over (table row, triggering event).
    Unqualified names bind to the triggering event first (the reference
    test idiom is ``on StockTable.symbol == symbol``: table side
    qualified, event side bare), then to the table (on-demand queries have
    no event side)."""

    def __init__(self, table_def, event_def, dictionary,
                 event_ref: Optional[str] = None):
        self.table_def = table_def
        self.event_def = event_def  # may be None (on-demand queries)
        self.dictionary = dictionary
        self.event_ref = event_ref

    def resolve(self, var: Variable) -> ColumnRef:
        sid = var.stream_id
        if sid == self.table_def.id:
            attr = self.table_def.attribute(var.attribute_name)
            return ColumnRef(TBL_PREFIX + attr.name, attr.type)
        if self.event_def is not None and (
                sid is None or sid in (self.event_def.id, self.event_ref)):
            try:
                attr = self.event_def.attribute(var.attribute_name)
                return ColumnRef(EV_PREFIX + attr.name, attr.type)
            except Exception:
                if sid is not None:
                    raise
        if sid is None:
            attr = self.table_def.attribute(var.attribute_name)
            return ColumnRef(TBL_PREFIX + attr.name, attr.type)
        raise CompileError(
            f"cannot resolve '{(sid + '.') if sid else ''}{var.attribute_name}' "
            f"in table condition")

    def encode_string(self, s: str) -> int:
        return self.dictionary.encode(s)


class InMemoryTable:
    # the unmatched events of an ``update or insert`` insert this many at a
    # time where none of them matches a row (the chain test is a [U, U]
    # mask); a chunk where one does walks its events one at a time, as the
    # reference walks them all; 0 walks every event
    insert_chunk = 4096

    def __init__(self, definition: TableDefinition, dictionary: StringDictionary,
                 device, capacity: int = 1024):
        from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException
        from siddhi_tpu_torch.ops.windows import window_col_specs
        from siddhi_tpu_torch.query_api.annotations import find_annotations

        self.definition = definition
        self.dictionary = dictionary
        self.device = torch.device(device)
        self.col_specs = window_col_specs(definition)
        self.capacity = capacity
        self.state = self._zero_state(capacity)
        self._lock = threading.RLock()
        # the owning app's context, wired by SiddhiAppRuntime after
        # construction (the overload layer's budget gates _ensure_room)
        self.app_context = None
        # @primaryKey: uniqueness + host hash probe (the dense analog of
        # reference IndexEventHolder's primary-key map)
        names = {a.name for a in definition.attributes}
        pk_anns = find_annotations(definition.annotations or [], "primaryKey")
        if len(pk_anns) > 1:
            raise SiddhiAppValidationException(
                f"table '{definition.id}': duplicate @PrimaryKey annotation")
        self.primary_key: List[str] = []
        if pk_anns:
            self.primary_key = [v for _k, v in pk_anns[0].elements if v]
            if not self.primary_key:
                raise SiddhiAppValidationException(
                    f"table '{definition.id}': @PrimaryKey needs at least "
                    "one attribute")
            for a in self.primary_key:
                if a not in names:
                    raise SiddhiAppValidationException(
                        f"table '{definition.id}': @PrimaryKey attribute "
                        f"'{a}' is not defined in the table")
        self._pk_map: Dict[tuple, int] = {}
        self._pk_dirty = False
        # @index: one attribute per annotation (reference
        # IndexTableTestCase indexTableTest31)
        self.indexes: List[str] = []
        for ann in find_annotations(definition.annotations or [], "index"):
            vals = [v for _k, v in ann.elements]
            if len(vals) != 1:
                raise SiddhiAppValidationException(
                    f"table '{definition.id}': @Index supports exactly one "
                    "attribute per annotation")
            a = vals[0]
            if a in self.indexes:
                raise SiddhiAppValidationException(
                    f"table '{definition.id}': duplicate @Index('{a}')")
            if not a or a not in names:
                raise SiddhiAppValidationException(
                    f"table '{definition.id}': @Index attribute '{a}' is "
                    "not defined in the table")
            self.indexes.append(a)
        self._idx_maps: Dict[str, Dict[object, np.ndarray]] = {}
        self._idx_dirty = True
        # the incremental snapshot's op log: rows inserted since the last
        # checkpoint; a delete or update makes the next capture a full one.
        # Off until persistence is in use (PersistenceManager turns it on),
        # so an app that never persists copies nothing
        self.journal_enabled = False
        self._journal: List[dict] = []
        self._journal_full = False

    # ------------------------------------------------------- primary key map

    def _pk_of_host(self, host_cols: dict, i: int) -> tuple:
        return tuple(host_cols[a][i].item() for a in self.primary_key)

    def _rebuild_pk_map(self):
        cols = {a: host(self.state["cols"][a]) for a in self.primary_key}
        valid = host(self.state["valid"])
        self._pk_map = {
            tuple(cols[a][i].item() for a in self.primary_key): int(i)
            for i in np.nonzero(valid)[0]}
        self._pk_dirty = False

    def find_by_pk(self, key: tuple) -> Optional[int]:
        """Slot of the row with this primary-key tuple (a hash probe, no
        scan). String components must be dictionary-encoded ints."""
        if not self.primary_key:
            return None
        with self._lock:
            if self._pk_dirty:
                self._rebuild_pk_map()
            return self._pk_map.get(tuple(key))

    # --------------------------------------------------- secondary indexes

    def probe_attrs(self) -> List[str]:
        """Attributes with an equality probe: the @index attributes plus a
        single-attribute @primaryKey."""
        out = list(self.indexes)
        if len(self.primary_key) == 1 and self.primary_key[0] not in out:
            out.append(self.primary_key[0])
        return out

    def _rebuild_idx_maps(self):
        live = np.nonzero(host(self.state["valid"]))[0]
        self._idx_maps = {}
        for a in self.probe_attrs():
            # group by value with one stable sort and a split
            col = host(self.state["cols"][a])[live]
            ok = ~host(self.state["cols"][a + "?"])[live]
            vals, slots = col[ok], live[ok].astype(np.int64)
            order = np.argsort(vals, kind="stable")
            sv, ss = vals[order], slots[order]
            uniq, starts = np.unique(sv, return_index=True)
            self._idx_maps[a] = {k.item(): p for k, p in
                                 zip(uniq, np.split(ss, starts[1:]))}
        self._idx_dirty = False

    def index_candidates(self, attr: str, value) -> Optional[np.ndarray]:
        """Slots whose ``attr`` equals ``value`` (a hash probe). None when
        the attribute has no index; empty when no row matches. String
        values must be dictionary-encoded ints that fit the column dtype
        (the probe compilers take this path only for non-narrowing types,
        ``_probe_type_safe``)."""
        if attr not in self.probe_attrs():
            return None
        with self._lock:
            if self._idx_dirty:
                self._rebuild_idx_maps()
            key = np.dtype(self.col_specs[attr]).type(value).item()
            hits = self._idx_maps.get(attr, {}).get(key)
            return hits if hits is not None else np.empty(0, np.int64)

    def _zero_state(self, cap: int) -> dict:
        return {
            "cols": {n: torch.zeros((cap,), dtype=to_torch_dtype(dt),
                                    device=self.device)
                     for n, dt in self.col_specs.items()},
            "valid": torch.zeros((cap,), dtype=torch.bool, device=self.device),
        }

    # ----------------------------------------------------------- capacity

    @property
    def count(self) -> int:
        return int(self.state["valid"].sum())

    def _row_bytes(self) -> int:
        return sum(np.dtype(dt).itemsize for dt in self.col_specs.values()) + 1

    def _ensure_room(self, n: int):
        needed = self.count + n
        cap = self.capacity
        if needed <= cap:
            return
        while cap < needed:
            cap *= 2
        ctx = self.app_context
        if ctx is not None and getattr(ctx, "overload", None) is not None:
            # the device-memory budget gate (resilience/overload.py): the
            # doubled allocation is denied before it happens
            from siddhi_tpu_torch.resilience.overload import (
                charge_memory,
                ensure_memory_budget,
            )

            comp = f"table.{self.definition.id}"
            ensure_memory_budget(
                ctx, comp, cap * self._row_bytes(),
                what=f"table '{self.definition.id}' capacity growth "
                     f"({self.capacity}->{cap} rows)")
            charge_memory(ctx, comp, cap * self._row_bytes())
        new = self._zero_state(cap)
        for name, col in new["cols"].items():
            col[: self.capacity] = self.state["cols"][name]
        new["valid"][: self.capacity] = self.state["valid"]
        self.state = new
        self.capacity = cap

    # ------------------------------------------------------- contents/probe

    def contents(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        with self._lock:
            return dict(self.state["cols"]), self.state["valid"]

    # ------------------------------------------------------------- actions

    def insert(self, batch: HostBatch):
        """Insert the batch's valid rows into the free slots, in arrival
        order. With @primaryKey a row duplicating a held (or an earlier
        inserted) key is dropped (reference IndexEventHolder rejects
        primary-key collisions)."""
        with self._lock:
            if batch.size == 0:
                return
            valid_h = host(batch.cols[VALID_KEY]).astype(bool).copy()
            if self.primary_key:
                if self._pk_dirty:
                    self._rebuild_pk_map()
                pk_cols = {a: host(batch.cols[a]) for a in self.primary_key}
                seen = set(self._pk_map)
                for i in np.nonzero(valid_h)[0]:
                    key = self._pk_of_host(pk_cols, int(i))
                    if key in seen:
                        valid_h[i] = False       # duplicate: dropped
                    else:
                        seen.add(key)
                self._pk_dirty = True
            self._idx_dirty = True
            n = int(valid_h.sum())
            if n == 0:
                return
            if self.journal_enabled and not self._journal_full:
                vidx = np.nonzero(valid_h)[0]
                self._journal.append({
                    name: (host(batch.cols[name])[vidx].copy()
                           if name in batch.cols
                           else np.zeros(vidx.size, self.col_specs[name]))
                    for name in self.state["cols"]})
            self._ensure_room(n)
            st, C, dev = self.state, self.capacity, self.device
            ar = torch.arange(C, dtype=torch.int64, device=dev)
            # free slots first, in slot order
            free_first = torch.argsort(torch.where(~st["valid"], ar, C + ar))
            valid = to_device(valid_h, dev)
            rank = torch.cumsum(valid.to(torch.int64), 0) - 1
            slot = free_first[torch.clamp(rank, 0, C - 1)]
            new_cols = {}
            for name, col in st["cols"].items():
                src = batch.cols.get(name)
                src = (torch.zeros(valid.shape[0], dtype=col.dtype, device=dev)
                       if src is None else to_device(src, dev))
                col = col.clone()
                put_where_(col, 0, slot, src, valid)
                new_cols[name] = col
            new_valid = st["valid"].clone()
            put_where_(new_valid, 0, slot, torch.ones_like(valid), valid)
            self.state = {"cols": new_cols, "valid": new_valid}

    def _event_cols(self, ev_cols: Optional[dict]) -> Tuple[dict, int]:
        """The eval dict of a condition or assignment: the event's columns
        as ``[B, 1]`` (``s__``-prefixed), the table's as ``[1, C]``."""
        ev = {}
        B = 1
        dev = self.device
        if ev_cols is not None:
            B = ev_cols[VALID_KEY].shape[0]
            for k, v in ev_cols.items():
                ev[EV_PREFIX + k] = to_device(v, dev)[:, None]
        for k, v in self.state["cols"].items():
            ev[TBL_PREFIX + k] = v[None, :]
        ev[TS_KEY] = ev.get(EV_PREFIX + TS_KEY,
                            torch.zeros((B, 1), dtype=torch.int64, device=dev))
        return ev, B

    def _match(self, cond: Optional[Callable], ev_cols: Optional[dict],
               ctx: Optional[dict] = None) -> torch.Tensor:
        """[B, C] match matrix of the condition over (event, table row)."""
        ev, B = self._event_cols(ev_cols)
        tvalid = self.state["valid"]
        C = tvalid.shape[0]
        ctx = {**(ctx or {}), "xp": TorchXP(self.device)}
        m = (torch.as_tensor(cond(ev, ctx), device=self.device)
             if cond is not None
             else torch.ones((B, C), dtype=torch.bool, device=self.device))
        m = m.expand(B, C) & tvalid[None, :]
        if ev_cols is not None:
            m = m & to_device(ev_cols[VALID_KEY], self.device).to(torch.bool)[:, None]
        return m

    def delete(self, cond: Optional[Callable], batch: Optional[HostBatch]):
        with self._lock:
            m = self._match(cond, batch.cols if batch is not None else None)
            self.state = {"cols": self.state["cols"],
                          "valid": self.state["valid"] & ~m.any(dim=0)}
            self._pk_dirty = True
            self._idx_dirty = True
            self._journal_full = True

    def update(self, cond: Optional[Callable], assignments,
               batch: Optional[HostBatch]) -> torch.Tensor:
        """``assignments``: ``[(table column, compiled expression over the
        event and table columns, type)]``. Where several events match one
        row the last one wins (the reference walks the chunk in order).
        Returns the ``[B, C]`` match matrix."""
        with self._lock:
            ev_cols = batch.cols if batch is not None else None
            m = self._match(cond, ev_cols)
            B, C = m.shape
            dev = self.device
            ev, _B = self._event_cols(ev_cols)
            ctx = {"xp": TorchXP(dev)}
            mats = []     # (column, values [B, C], mask [B, C] or None)
            for col_name, fn, _t in assignments:
                v, mask = fn(ev, ctx)
                mats.append((col_name,
                             torch.as_tensor(v, device=dev).expand(B, C),
                             None if mask is None
                             else torch.as_tensor(mask, device=dev).expand(B, C)))

            pk_touched = self.primary_key and any(
                col in self.primary_key for col, _f, _t in assignments)
            if not pk_touched:
                # the winning (last matching) event of each row, -1 if none
                ridx = torch.arange(1, B + 1, dtype=torch.int64, device=dev)
                win = torch.where(m, ridx[:, None], 0).amax(dim=0) - 1
            else:
                win = torch.as_tensor(self._pk_update_winners(m, mats),
                                      device=dev)
            hit = win >= 0
            wsafe = torch.clamp(win, 0, B - 1)
            cidx = torch.arange(C, device=dev)
            new_cols = dict(self.state["cols"])
            for col_name, v, mask in mats:
                old = new_cols[col_name]
                val = v[wsafe, cidx]
                # the column takes the promoted type, as jnp.where gives it
                dt = torch.promote_types(old.dtype, val.dtype)
                new_cols[col_name] = torch.where(hit, val.to(dt), old.to(dt))
                mk = (mask[wsafe, cidx] if mask is not None
                      else torch.zeros(C, dtype=torch.bool, device=dev))
                new_cols[col_name + "?"] = torch.where(
                    hit, mk, new_cols[col_name + "?"])
            self.state = {"cols": new_cols, "valid": self.state["valid"]}
            self._pk_dirty = True
            self._idx_dirty = True
            self._journal_full = True
            return m

    def _pk_update_winners(self, m: torch.Tensor, mats) -> np.ndarray:
        """The winning event of each row ([C], -1 = none) of an update
        that assigns primary-key columns, walking the events in order as
        the reference does. For a single-attribute key an event's key
        rewrites are first simulated against the live key set, and any
        collision drops the whole event (IndexOperator.java:117-161);
        composite keys drop only the colliding row."""
        B, C = m.shape
        live = host(self.state["valid"]).astype(bool)
        m_h = host(m).astype(bool) & live[None, :]
        pk_vals = {col: host(v) for col, v, _mk in mats if col in self.primary_key}
        if self._pk_dirty:
            self._rebuild_pk_map()
        keys = dict(self._pk_map)
        old_k = {a: host(self.state["cols"][a]) for a in self.primary_key}
        cur_key = {int(c): self._pk_of_host(old_k, int(c))
                   for c in np.nonzero(live)[0]}
        win = np.full(C, -1, np.int64)
        single_pk = len(self.primary_key) == 1
        kset = set(keys) if single_pk else None

        def new_key(b, c):
            return tuple(pk_vals[a][b, c].item() if a in pk_vals
                         else cur_key[c][i]
                         for i, a in enumerate(self.primary_key))

        for b in range(B):
            rows = [int(c) for c in np.nonzero(m_h[b])[0]]
            if not rows:
                continue
            if single_pk:
                moves = []
                ok = True
                for c in rows:
                    nk = new_key(b, c)
                    if nk != cur_key[c]:
                        kset.discard(cur_key[c])
                        if nk in kset:
                            kset.add(cur_key[c])
                            ok = False
                            break
                        kset.add(nk)
                        moves.append((c, cur_key[c], nk))
                if not ok:
                    for c, old, nk in reversed(moves):
                        kset.discard(nk)
                        kset.add(old)
                    continue       # the whole updating event is dropped
                for c, old, nk in moves:
                    del keys[old]
                    keys[nk] = c
                    cur_key[c] = nk
                for c in rows:
                    win[c] = b
            else:
                for c in rows:
                    nk = new_key(b, c)
                    if nk != cur_key[c] and keys.get(nk, c) != c:
                        continue   # a violation: the row is dropped
                    if nk != cur_key[c]:
                        del keys[cur_key[c]]
                        keys[nk] = c
                        cur_key[c] = nk
                    win[c] = b
        return win

    def update_or_insert(self, cond, assignments, batch: HostBatch,
                         insert_mapping=None):
        """Per event in order: a row inserted by one event is visible to
        the later events of the chunk (reference UpdateOrInsertReducer).
        The batch update handles every matching event; only the unmatched
        ones run one at a time. ``insert_mapping`` pairs each table
        attribute with the event column an unmatched event inserts (None
        inserts null)."""
        with self._lock:
            m = self.update(cond, assignments, batch)
            unmatched = ~host(m.any(dim=1)) & host(batch.cols[VALID_KEY]).astype(bool)
            if not unmatched.any():
                return
            cols = {k: host(v) for k, v in batch.cols.items()}
            idx = np.nonzero(unmatched)[0]
            chunk = self.insert_chunk or len(idx)
            for lo in range(0, len(idx), chunk):
                part = idx[lo: lo + chunk]
                if self.insert_chunk and insert_mapping is not None:
                    events = {k: v[part] for k, v in cols.items()}
                    rows = insert_rows(self.col_specs, events, insert_mapping)
                    # no event of the chunk matches a row the table holds
                    # now or a row an earlier one of the chunk inserts:
                    # one insert is the walk in order
                    if (not bool(self._match(cond, events).any())
                            and not self._chained(cond, events, rows)):
                        self.insert(HostBatch(rows))
                        continue
                for i in part:
                    row = {k: v[i: i + 1] for k, v in cols.items()}
                    row[VALID_KEY] = np.ones(1, bool)
                    single = HostBatch(row)
                    if bool(self.update(cond, assignments, single).any()):
                        continue
                    if insert_mapping is not None:
                        single = HostBatch(insert_rows(self.col_specs, row, insert_mapping))
                    self.insert(single)

    def _chained(self, cond, events: dict, rows: dict) -> bool:
        """Would an event match a row inserted by an earlier event of the
        same chunk? The condition over (event j, row i) for every pair:
        ``[U, U]`` with U at most ``insert_chunk``, true below the
        diagonal somewhere (no condition matches every row)."""
        U = events[VALID_KEY].shape[0]
        if cond is None:
            return U > 1
        dev = self.device
        ev = {EV_PREFIX + k: to_device(v, dev)[:, None] for k, v in events.items()}
        ev.update({TBL_PREFIX + k: to_device(v, dev)[None, :]
                   for k, v in rows.items() if k in self.col_specs})
        ev[TS_KEY] = ev[EV_PREFIX + TS_KEY]
        m = torch.as_tensor(cond(ev, {"xp": TorchXP(dev)}), device=dev).expand(U, U)
        return bool(torch.tril(m, diagonal=-1).any())

    # ------------------------------------------------------------ decoding

    # ----------------------------------------------- incremental snapshots

    def incremental_snapshot(self) -> dict:
        """The insert journal since the last checkpoint, or the full state
        when a delete or update voided it. Pure capture: ``clear_oplog``
        runs only once the checkpoint is saved."""
        with self._lock:
            if self._journal_full:
                return {"full": {"cols": {k: host(v).copy()
                                          for k, v in self.state["cols"].items()},
                                 "valid": host(self.state["valid"]).copy()},
                        "capacity": self.capacity}
            return {"journal": list(self._journal)}

    def clear_oplog(self):
        with self._lock:
            self._journal = []
            self._journal_full = False

    def apply_increment(self, snap: dict):
        """Apply one checkpoint's op log on top of restored state."""
        if "full" in snap:
            from siddhi_tpu_torch.core.util.snapshot import install_table_state

            install_table_state(self, snap["full"], snap["capacity"])
            return
        # replay without journaling: the restored chain already holds
        # these rows (journaling them would duplicate on the next restore)
        was = self.journal_enabled
        self.journal_enabled = False
        try:
            for rows in snap.get("journal", []):
                n = len(next(iter(rows.values()))) if rows else 0
                if n == 0:
                    continue
                cols = {k: v.copy() for k, v in rows.items()}
                cols[VALID_KEY] = np.ones(n, bool)
                self.insert(HostBatch(cols))
        finally:
            self.journal_enabled = was

    def all_events(self) -> List[Event]:
        cols, valid = self.contents()
        hcols = {k: host(v) for k, v in cols.items()}
        hcols[VALID_KEY] = host(valid)
        hcols[TYPE_KEY] = np.zeros(hcols[VALID_KEY].shape[0], np.int8)
        return HostBatch(hcols).to_events(
            [(a.name, a.type) for a in self.definition.attributes], self.dictionary)
