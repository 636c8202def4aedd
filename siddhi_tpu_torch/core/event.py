"""Event model: user-facing Event rows and columnar batches.

Counterpart of ``siddhi_tpu/core/event.py``: each stream batch is one
numpy array per attribute plus timestamp, event-type and validity columns
on the host, moved to the device as torch tensors for the query step. The
CURRENT/EXPIRED/TIMER/RESET event types are an int8 column.

The string dictionary encodes bulk columns through the native mirror
(``native/strdict.cpp``), as the reference does; its pure-Python probe is
kept as the plain version the tests hold the native one against.

Set-valued (OBJECT) attributes: a singleton set (a ``createSet`` output)
is one int64 column holding its element's identity code; a multi-element
set (a ``unionSet`` output) is its live count plus ``'<name>#set'``
(element codes) and ``'<name>#setm'`` (live mask) ``[B, H]`` companions.

With batch journeys on (``observability/journey.py``) a batch is stamped
where it is packed (``HostBatch.journey``): the pack stage's service
time, the slowest sub-batch plus the serial merge on the ingest pool.
"""

from __future__ import annotations

import ctypes
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from siddhi_tpu_torch.observability import journey
from siddhi_tpu_torch.observability.tracing import NOOP_SPAN, TRACER, span
from siddhi_tpu_torch.ops.expressions import (
    TS_KEY, TYPE_KEY, VALID_KEY, decode_set_element, encode_set_value)
from siddhi_tpu_torch.ops.types import dtype_of
from siddhi_tpu_torch.query_api.definitions import AbstractDefinition, AttrType

# ComplexEvent.Type (reference event/ComplexEvent.java)
CURRENT = 0
EXPIRED = 1
TIMER = 2
RESET = 3

TYPE_NAMES = {CURRENT: "CURRENT", EXPIRED: "EXPIRED", TIMER: "TIMER", RESET: "RESET"}


@dataclass
class Event:
    """User-facing event (reference ``core/event/Event.java``)."""

    timestamp: int = -1
    data: Sequence = field(default_factory=list)
    is_expired: bool = False
    # partition-key id, attached only when a partitioned rate limiter
    # routes output events per key
    pk: Optional[int] = None
    # dense group-key id, attached only when a grouped rate limiter needs
    # a group key the selection does not project
    gk: Optional[int] = None

    def __repr__(self):
        return f"Event{{timestamp={self.timestamp}, data={list(self.data)}, isExpired={self.is_expired}}}"


_NATIVE_INIT_LOCK = threading.Lock()


class StringDictionary:
    """App-global string <-> int32 id dictionary. Strings never reach the
    device: keys and symbols travel as dense ids. Ids are assigned in
    first-seen order and never change.

    Bulk encodes probe a native mirror of the id map (``native/strdict.cpp``)
    once per string. Python stays authoritative for the id space: the
    mirror only ever holds (string, id) pairs that already exist in
    ``_to_id``, and new strings are resolved serially in row order."""

    NULL_ID = -1
    _MISS = -2

    def __init__(self):
        self._to_id: Dict[str, int] = {}
        self._to_str: List[str] = []
        # id assignment is check-then-append: concurrent producers must
        # not give one new string two ids
        self._insert_lock = threading.Lock()
        # the native mirror, created on the first bulk encode
        self._native = None
        self._native_lib = None
        self._rank_cache = None

    def encode(self, s: Optional[str]) -> int:
        if s is None:
            return self.NULL_ID
        i = self._to_id.get(s)
        if i is None:
            with self._insert_lock:
                i = self._to_id.get(s)
                if i is None:
                    i = len(self._to_str)
                    self._to_str.append(s)
                    if self._native is not None:
                        self._mirror_insert(s, i)
                    # publish the id last: a lock-free reader that sees the
                    # dict entry must find _to_str[i] present
                    self._to_id[s] = i
        return i

    def lookup(self, s: str) -> Optional[int]:
        """The id of ``s``, or None if it has none: assigns nothing."""
        return self._to_id.get(s)

    def _mirror_insert(self, s: str, i: int):
        try:
            b = s.encode("utf-8")
        except UnicodeEncodeError:
            # lone surrogates cannot round-trip utf-8; the native probe
            # reports them as misses and Python resolves them
            return
        self._native_lib.strdict_insert(self._native, b, len(b), i)

    def restore_strings(self, strings: List[str]):
        """Replace the id space wholesale (state carried from elsewhere);
        the native mirror is rebuilt, or it would serve ids of the
        discarded space."""
        with self._insert_lock:
            self._to_str = list(strings)
            self._to_id = {s: i for i, s in enumerate(self._to_str)}
            if self._native is not None:
                self._native_lib.strdict_clear(self._native)
                for i, s in enumerate(self._to_str):
                    self._mirror_insert(s, i)

    def decode(self, i: int) -> Optional[str]:
        if i < 0:
            return None
        return self._to_str[i]

    def rank_table(self, min_capacity: int = 16) -> np.ndarray:
        """Lexicographic rank per id, padded to a pow2 capacity with at
        least one pad slot (a negative id wraps to the end, which ranks
        after every string, so nulls sort last). Ids follow arrival order,
        so ``order by`` on a string column sorts by this rank, not the id.
        Cached per dictionary size."""
        n = len(self._to_str)
        cap = max(min_capacity, 16)
        while cap < n + 1:
            cap *= 2
        cached = self._rank_cache
        if cached is not None and cached[0] == n and len(cached[1]) == cap:
            return cached[1]
        table = np.full(cap, n, np.int32)
        if n:
            order = sorted(range(n), key=lambda i: self._to_str[i])
            table[np.asarray(order, np.int64)] = np.arange(n, dtype=np.int32)
        self._rank_cache = (n, table)
        return table

    def _ensure_native(self):
        """Build the native mirror once (concurrent first probes build it
        exactly once); a failed library build raises."""
        if self._native is not None:
            return
        with _NATIVE_INIT_LOCK:
            if self._native is not None:
                return
            from siddhi_tpu_torch.native import strdict_lib

            lib = strdict_lib()
            handle = ctypes.c_void_p(lib.strdict_new())
            weakref.finalize(self, lib.strdict_free, handle)
            with self._insert_lock:
                # a probe racing the backfill sees a miss at worst, which
                # resolve_missing maps to the right id: never a wrong one
                self._native_lib = lib
                self._native = handle
                for s, i in self._to_id.items():
                    self._mirror_insert(s, i)

    def probe_array(self, values: np.ndarray) -> np.ndarray:
        """Read-only bulk probe through the native mirror: ids for known
        strings, ``NULL_ID`` for None, ``_MISS`` for everything else (new
        strings, non-str values). Nothing is inserted."""
        arr = np.ascontiguousarray(np.asarray(values, object))
        out = np.empty(len(arr), np.int64)
        self._ensure_native()
        self._native_lib.strdict_encode(
            self._native, arr.ctypes.data_as(ctypes.c_void_p), len(arr),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.NULL_ID, self._MISS)
        return out

    def probe_array_plain(self, values: np.ndarray) -> np.ndarray:
        """``probe_array`` as a Python dict probe per value: the plain
        version the native probe is held against (None also misses here;
        ``resolve_missing`` maps it to ``NULL_ID``)."""
        arr = np.asarray(values, object)
        get = self._to_id.get
        return np.fromiter((get(v, self._MISS) for v in arr), np.int64, len(arr))

    def resolve_missing(self, ids: np.ndarray, value_of) -> None:
        """Second phase of a bulk encode: replace every ``_MISS`` in
        ``ids``, in index order, by encoding ``value_of(i)``, so id
        assignment matches per-value ``encode`` calls."""
        for i in np.nonzero(ids == self._MISS)[0]:
            v = value_of(int(i))
            ids[i] = (self.NULL_ID if v is None
                      else self.encode(v if type(v) is str else str(v)))

    def encode_array(self, values: np.ndarray) -> np.ndarray:
        """Bulk encoding: one native probe pass, then the misses (new
        strings, Nones, non-str values) resolved serially in row order."""
        arr = np.ascontiguousarray(np.asarray(values, object))
        out = self.probe_array(arr)
        self.resolve_missing(out, lambda i: arr[i])
        return out

    def __len__(self):
        return len(self._to_str)


def encode_key_tuples(arrays, rows: np.ndarray, id_of) -> np.ndarray:
    """Dense ids for key tuples taken row-wise from ``arrays`` at ``rows``:
    structured-array ``np.unique``, then one dictionary probe per unique
    tuple (shared by GroupKeyer and ValuePartitionKeyer)."""
    B = arrays[0].shape[0]
    rec = np.empty(B, dtype=[(f"k{i}", a.dtype) for i, a in enumerate(arrays)])
    for i, a in enumerate(arrays):
        rec[f"k{i}"] = a
    uniq, inv = np.unique(rec[rows], return_inverse=True)
    lut = np.empty(len(uniq), np.int32)
    for u_i in range(len(uniq)):
        lut[u_i] = id_of(tuple(x.item() for x in uniq[u_i]))
    return lut[inv.reshape(-1)]


_NONE_MASK = np.frompyfunc(lambda v: v is None, 1, 1)


def pack_pool_of(app_context):
    """The app's ingest pack pool, or None (``siddhi_tpu.ingest_pool`` 0,
    or no context): the one accessor every pack call site uses."""
    if app_context is None:
        return None
    return getattr(app_context, "ingest_pack_pool", None)


def _journey_t0() -> Optional[float]:
    """The pack stage's start when batch journeys are on, else None: one
    flag check a batch. A planted pack delay (``journey.maybe_delay``, the
    tests' known bottleneck) falls inside the timed window."""
    if not journey.enabled():
        return None
    t0 = time.perf_counter()
    journey.maybe_delay("pack")
    return t0


def _pad_len(n: int, minimum: int = 8) -> int:
    """Pad batch length to a power of two (the reference's recompile
    bound; kept so batch shapes, and thus outputs, match it row for row)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def tensors_to_numpy(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of ``tensors``. Device tensors come over in ONE copy:
    their bytes are packed into one flat device buffer, copied once, and
    cut back into typed arrays on the host."""
    out: List[Optional[np.ndarray]] = [None] * len(tensors)
    dev = [i for i, t in enumerate(tensors) if t.device.type != "cpu"]
    for i, t in enumerate(tensors):
        if t.device.type == "cpu":
            out[i] = t.numpy()
    if dev:
        flats = [tensors[i].contiguous().reshape(-1).view(torch.uint8)
                 for i in dev]
        host = torch.cat(flats).cpu().numpy()
        off = 0
        for i, f in zip(dev, flats):
            t = tensors[i]
            nb = f.numel()
            np_dt = torch.empty(0, dtype=t.dtype).numpy().dtype
            out[i] = host[off:off + nb].view(np_dt).reshape(tuple(t.shape))
            off += nb
    return out


def _delivering_stream() -> Optional[str]:
    """The stream whose delivery reads a batch's columns (a span's arg)."""
    from siddhi_tpu_torch.core.stream.junction import current_delivering_junction

    j = current_delivering_junction()
    return j.definition.id if j is not None else None


class LazyColumns(dict):
    """Column dict whose tensor values become numpy on first access. The
    first touched tensor column pulls every remaining tensor column in one
    device-to-host copy (``tensors_to_numpy``); consumers that read only
    the meta's size hint pull nothing."""

    def __getitem__(self, k):
        v = super().__getitem__(k)
        if not isinstance(v, np.ndarray):
            self._materialize_all()
            v = super().__getitem__(k)
        return v

    def _materialize_all(self):
        pending = [(key, val) for key, val in super().items()
                   if isinstance(val, torch.Tensor)]
        if not pending:
            return
        with span("sync.columns", stream=_delivering_stream(),
                  columns=len(pending)) if TRACER.enabled else NOOP_SPAN:
            pulled = tensors_to_numpy([v for _k, v in pending])
        for (key, _v), arr in zip(pending, pulled):
            super().__setitem__(key, arr)

    def get(self, k, default=None):
        if k in self:
            return self[k]
        return default

    def pop(self, k, *default):
        # pops pull ONLY the popped value (control scalars like __meta__
        # must not drag every data column across)
        if k in self:
            v = super().__getitem__(k)
            dict.pop(self, k)
            if isinstance(v, torch.Tensor):
                v = tensors_to_numpy([v])[0]
            return v
        if default:
            return default[0]
        raise KeyError(k)


class HostBatch:
    """Columnar batch on host. Column keys: attribute names, reserved
    ``__ts__`` (i64), ``__type__`` (i8), ``__valid__`` (bool) and per-
    attribute null masks under ``<key>?``. Columns may be device tensors
    held in a ``LazyColumns`` that pull on first read."""

    # the batch journey stamped at pack (observability/journey.py), or None
    journey = None

    def __init__(self, cols: Dict[str, np.ndarray], size: Optional[int] = None):
        self.cols = cols
        self._size = size        # known valid-row count (avoids a pull)

    @property
    def size(self) -> int:
        if self._size is None:
            self._size = int(np.asarray(self.cols[VALID_KEY]).sum())
        return self._size

    @property
    def capacity(self) -> int:
        return self.cols[VALID_KEY].shape[0]

    @staticmethod
    def from_events(events: Sequence[Event], definition: AbstractDefinition,
                    dictionary: StringDictionary, pad_to: Optional[int] = None,
                    event_type: int = CURRENT, pool=None) -> "HostBatch":
        with span("input.encode", stream=definition.id, rows=len(events)):
            return _encode_events(events, definition, dictionary, pad_to,
                                  event_type, pool)

    @staticmethod
    def from_columns(data: Dict[str, np.ndarray], definition: AbstractDefinition,
                     dictionary: StringDictionary,
                     timestamps: Optional[np.ndarray] = None,
                     default_ts: int = 0,
                     pad_to: Optional[int] = None, pool=None) -> "HostBatch":
        """Columnar ingestion: ``data`` maps attribute names to arrays
        (strings as object/str arrays, encoded here, or pre-encoded int
        ids). ``<name>?`` null-mask arrays are optional."""
        with span("input.encode", stream=definition.id,
                  rows=len(next(iter(data.values())))):
            return _encode_columns(data, definition, dictionary, timestamps,
                                   default_ts, pad_to, pool)

    def to_events(self, attr_order: Sequence[tuple],
                  dictionary: StringDictionary,
                  object_meta: Optional[Dict[str, object]] = None,
                  object_multi: Optional[set] = None,
                  pk_key: Optional[str] = None,
                  gk_key: Optional[str] = None) -> List[Event]:
        """Decode valid rows into Events. ``object_meta`` maps OBJECT (set-
        valued) attributes to their element AttrType (raw int codes
        without it); ``object_multi`` names the multi-element ones, whose
        decode raises when their '#set' companions were dropped instead
        of emitting the live count as a singleton; ``pk_key``/``gk_key``
        name a partition-id/group-id column to attach as ``Event.pk``/
        ``Event.gk``."""
        types = np.asarray(self.cols[TYPE_KEY])
        ts = np.asarray(self.cols[TS_KEY])
        idx = np.nonzero(np.asarray(self.cols[VALID_KEY]))[0]
        if idx.size == 0:
            return []
        col_lists: List[list] = []
        for key, attr_type in attr_order:
            vals = np.asarray(self.cols[key])[idx]
            if attr_type == AttrType.OBJECT:
                lst = self._decode_sets(key, vals, idx, dictionary,
                                        (object_meta or {}).get(key),
                                        bool(object_multi) and key in object_multi)
            elif attr_type == AttrType.STRING:
                lst = [dictionary.decode(int(v)) for v in vals]
            elif attr_type == AttrType.BOOL:
                lst = [bool(v) for v in vals]
            elif attr_type in (AttrType.INT, AttrType.LONG):
                lst = vals.astype(np.int64).tolist()
            else:
                lst = vals.astype(np.float64).tolist()
            mask = self.cols.get(key + "?")
            if mask is not None:
                mvals = np.asarray(mask)[idx]
                if mvals.any():
                    lst = [None if m else v for v, m in zip(lst, mvals)]
            col_lists.append(lst)
        ts_l = ts[idx].tolist()
        exp_l = (types[idx] == EXPIRED).tolist()
        rows = zip(*col_lists) if col_lists else ([] for _ in idx)
        events = [Event(timestamp=t, data=list(r), is_expired=e)
                  for t, e, r in zip(ts_l, exp_l, rows)]
        for key, attr in ((pk_key, "pk"), (gk_key, "gk")):
            col = self.cols.get(key) if key is not None else None
            if col is not None:
                for ev, v in zip(events, np.asarray(col)[idx].tolist()):
                    setattr(ev, attr, int(v))
        return events

    def _decode_sets(self, key, vals, idx, dictionary, elem_t, multi) -> list:
        """Set values of the rows ``idx``: from the '#set'/'#setm'
        companions (unionSet snapshots), else one singleton per row whose
        value is the element code (createSet transport)."""
        snap = self.cols.get(key + "#set")
        if snap is not None:
            sv = np.asarray(snap)[idx]
            sm = np.asarray(self.cols[key + "#setm"])[idx]
            return [frozenset(decode_set_element(c, elem_t, dictionary)
                              for c in row_v[row_m])
                    for row_v, row_m in zip(sv, sm)]
        if multi:
            # the base column of a multi set is its live COUNT: decoding it
            # as an element would be silent garbage
            raise ValueError(
                f"multi-element set attribute '{key}' lost its '#set' "
                f"element snapshot (a window buffers only the base column); "
                f"project it before windowing")
        return [frozenset([decode_set_element(v, elem_t, dictionary)])
                for v in vals]


def _encode_events(events, definition, dictionary, pad_to, event_type,
                   pool) -> HostBatch:
    """``HostBatch.from_events``'s encode, inline or on the ingest pool."""
    if pool is not None:
        chunks = pool.plan_events(len(events), definition)
        if chunks is not None:
            # the encode work runs as sequence-numbered sub-batches on
            # the app's ingest pool (core/stream/input/pack_pool.py);
            # the ordered merge keeps outputs and dictionary ids
            # bit-identical to this inline path
            return _parallel_from_events(pool, chunks, events, definition,
                                         dictionary, pad_to, event_type)
    t0 = _journey_t0()
    n = len(events)
    b = pad_to if pad_to is not None else _pad_len(n)
    cols: Dict[str, np.ndarray] = {
        TS_KEY: np.zeros(b, np.int64),
        TYPE_KEY: np.full(b, event_type, np.int8),
        VALID_KEY: np.zeros(b, bool),
    }
    cols[VALID_KEY][:n] = True
    if n:
        cols[TS_KEY][:n] = np.fromiter(
            (ev.timestamp for ev in events), np.int64, n)
        expired = np.fromiter((ev.is_expired for ev in events), bool, n)
        if expired.any():
            cols[TYPE_KEY][:n][expired] = EXPIRED
    rows = [ev.data for ev in events]
    for pos, attr in enumerate(definition.attributes):
        arr = np.zeros(b, dtype_of(attr.type))
        # null masks are always present so the column set is static
        mask = np.zeros(b, bool)
        if n and attr.type == AttrType.OBJECT:
            _encode_object_column(cols, arr, mask, attr.name, b,
                                  [r[pos] for r in rows], definition,
                                  dictionary)
        elif n:
            col = np.fromiter((r[pos] for r in rows), object, n)
            if attr.type == AttrType.STRING:
                ids = dictionary.encode_array(col)
                mask[:n] = ids == StringDictionary.NULL_ID
                arr[:n] = np.where(mask[:n], 0, ids)
            else:
                zero = False if attr.type == AttrType.BOOL else 0
                nulls = _NONE_MASK(col).astype(bool)
                if nulls.any():
                    mask[:n] = nulls
                    arr[:n] = np.where(nulls, zero, col)
                else:
                    arr[:n] = col
        cols[attr.name] = arr
        cols[attr.name + "?"] = mask
    batch = HostBatch(cols)
    if t0 is not None:
        journey.stamp_pack(batch, t0)
    return batch


def _encode_columns(data, definition, dictionary, timestamps, default_ts,
                    pad_to, pool) -> HostBatch:
    """``HostBatch.from_columns``'s encode, inline or on the ingest pool."""
    if pool is not None:
        chunks = pool.plan_columns(data, definition)
        if chunks is not None:
            return _parallel_from_columns(pool, chunks, data, definition,
                                          dictionary, timestamps,
                                          default_ts, pad_to)
    t0 = _journey_t0()
    first = next(iter(data.values()))
    n = len(first)
    b = pad_to if pad_to is not None else _pad_len(n)
    cols: Dict[str, np.ndarray] = {
        TYPE_KEY: np.full(b, CURRENT, np.int8),
        VALID_KEY: np.zeros(b, bool),
    }
    cols[VALID_KEY][:n] = True
    ts = np.zeros(b, np.int64)
    if timestamps is not None:
        ts[:n] = np.asarray(timestamps, np.int64)[:n]
    else:
        ts[:n] = default_ts
    cols[TS_KEY] = ts
    for attr in definition.attributes:
        if attr.name not in data:
            raise KeyError(f"column '{attr.name}' missing from batch")
        src = np.asarray(data[attr.name])
        arr = np.zeros(b, dtype_of(attr.type))
        mask = np.zeros(b, bool)
        if attr.type == AttrType.STRING and not np.issubdtype(src.dtype, np.integer):
            ids = dictionary.encode_array(src)[:n]
            mask[:n] = ids == StringDictionary.NULL_ID
            arr[:n] = np.where(mask[:n], 0, ids)
        elif attr.type == AttrType.STRING:
            ids = np.asarray(src[:n], np.int64)
            mask[:n] = ids < 0  # pre-encoded: negative = null
            arr[:n] = np.where(mask[:n], 0, ids)
        else:
            arr[:n] = src[:n]
        user_mask = data.get(attr.name + "?")
        if user_mask is not None:
            mask[:n] |= np.asarray(user_mask, bool)[:n]
        cols[attr.name] = arr
        cols[attr.name + "?"] = mask
    batch = HostBatch(cols)
    if t0 is not None:
        journey.stamp_pack(batch, t0)
    return batch


def _encode_object_column(cols, arr, mask, name, b, values, definition,
                          dictionary) -> None:
    """Set ingestion from Events (reference ``HostBatch.from_events``).
    Element codes follow the stream's recorded element type; a multi-
    element attribute (a unionSet output) becomes its live count plus
    '#set'/'#setm' companions as wide as the largest set, a singleton its
    element code. Fills ``arr``/``mask`` and adds the companions."""
    elem_t = (getattr(definition, "object_elem_types", None) or {}).get(name)
    multi = name in (getattr(definition, "object_multi_attrs", None) or set())
    as_sets, nulls = [], []
    for i, val in enumerate(values):
        if val is None:
            nulls.append(i)
            as_sets.append(frozenset())
        elif isinstance(val, (set, frozenset)):
            as_sets.append(val)
        else:
            as_sets.append(frozenset([val]))
    if multi:
        H = max(1, max((len(s) for s in as_sets), default=1))
        snap = np.zeros((b, H), np.int64)
        snapm = np.zeros((b, H), bool)
        for i, s in enumerate(as_sets):
            for j, el in enumerate(s):
                snap[i, j] = encode_set_value(el, elem_t, dictionary)
                snapm[i, j] = True
            arr[i] = len(s)
        cols[name + "#set"] = snap
        cols[name + "#setm"] = snapm
    else:
        for i, s in enumerate(as_sets):
            if len(s) > 1:
                raise ValueError(
                    f"attribute '{name}' carries singleton sets (createSet "
                    f"transport); got a multi-element set")
            if s:
                arr[i] = encode_set_value(next(iter(s)), elem_t, dictionary)
    if nulls:
        mask[nulls] = True


# ------------------------------------------------------ parallel ordered pack
#
# The multicore half of HostBatch.from_events / from_columns: the encode
# work of ONE batch is split into sequence-numbered row-range sub-batches
# that run on the app's IngestPackPool workers, each writing a disjoint
# slice of the pre-allocated output columns. The ordered merge — waiting
# the sub-batches out in sequence order, then resolving every NEW string
# serially in attribute-major row order — keeps the produced arrays AND
# the dictionary's id-assignment order bit-identical to the inline path.

def _parallel_from_events(pool, chunks, events, definition, dictionary,
                          pad_to, event_type) -> HostBatch:
    jt = journey.enabled()
    n = len(events)
    b = pad_to if pad_to is not None else _pad_len(n)
    cols: Dict[str, np.ndarray] = {
        TS_KEY: np.zeros(b, np.int64),
        TYPE_KEY: np.full(b, event_type, np.int8),
        VALID_KEY: np.zeros(b, bool),
    }
    cols[VALID_KEY][:n] = True
    attrs = definition.attributes
    arrs: Dict[str, np.ndarray] = {}
    masks: Dict[str, np.ndarray] = {}
    scratch: Dict[str, np.ndarray] = {}   # string probe ids (_MISS marked)
    positions = {}
    for pos, attr in enumerate(attrs):
        arrs[attr.name] = np.zeros(b, dtype_of(attr.type))
        masks[attr.name] = np.zeros(b, bool)
        positions[attr.name] = pos
        if attr.type == AttrType.STRING:
            scratch[attr.name] = np.empty(n, np.int64)

    def pack_chunk(lo: int, hi: int) -> None:
        if jt:
            journey.maybe_delay("pack")   # a planted bottleneck
        m = hi - lo
        sub = events[lo:hi]
        cols[TS_KEY][lo:hi] = np.fromiter(
            (ev.timestamp for ev in sub), np.int64, m)
        expired = np.fromiter((ev.is_expired for ev in sub), bool, m)
        if expired.any():
            cols[TYPE_KEY][lo:hi][expired] = EXPIRED
        rows = [ev.data for ev in sub]
        for pos, attr in enumerate(attrs):
            col = np.fromiter((r[pos] for r in rows), object, m)
            if attr.type == AttrType.STRING:
                # probe only — new strings stay _MISS markers for the
                # serial merge (deterministic id assignment)
                scratch[attr.name][lo:hi] = dictionary.probe_array(col)
            else:
                zero = False if attr.type == AttrType.BOOL else 0
                nulls = _NONE_MASK(col).astype(bool)
                if nulls.any():
                    masks[attr.name][lo:hi] = nulls
                    arrs[attr.name][lo:hi] = np.where(nulls, zero, col)
                else:
                    arrs[attr.name][lo:hi] = col

    chunk_ms = pool.run_ordered(chunks, pack_chunk)
    t_merge = time.perf_counter()
    for attr in attrs:
        if attr.type == AttrType.STRING:
            ids = scratch[attr.name]
            pos = positions[attr.name]
            # serial miss resolution in row order, attributes in
            # declaration order — the exact insertion order the inline
            # per-attribute encode_array produces
            dictionary.resolve_missing(
                ids, lambda i, _p=pos: events[i].data[_p])
            mask = ids == StringDictionary.NULL_ID
            masks[attr.name][:n] = mask
            arrs[attr.name][:n] = np.where(mask, 0, ids)
        cols[attr.name] = arrs[attr.name]
        cols[attr.name + "?"] = masks[attr.name]
    return _stamped(pool, HostBatch(cols), jt, chunk_ms, t_merge)


def _stamped(pool, batch: HostBatch, jt: bool, chunk_ms, t_merge: float) -> HostBatch:
    """A pool-packed batch, its serial merge recorded on the pool, with
    its pack stamp: max, not sum (the sub-batches were packed at once),
    the slowest packer plus the serial merge."""
    merge_ms = (time.perf_counter() - t_merge) * 1000.0
    pool.record_merge(merge_ms)
    if jt:
        journey.stamp_pack_ms(batch, max(chunk_ms, default=0.0) + merge_ms)
    return batch


def _parallel_from_columns(pool, chunks, data, definition, dictionary,
                           timestamps, default_ts, pad_to) -> HostBatch:
    jt = journey.enabled()
    first = next(iter(data.values()))
    n = len(first)
    b = pad_to if pad_to is not None else _pad_len(n)
    cols: Dict[str, np.ndarray] = {
        TYPE_KEY: np.full(b, CURRENT, np.int8),
        VALID_KEY: np.zeros(b, bool),
    }
    cols[VALID_KEY][:n] = True
    ts = np.zeros(b, np.int64)
    if timestamps is not None:
        ts_src = np.asarray(timestamps, np.int64)
    else:
        ts_src = None
        ts[:n] = default_ts
    cols[TS_KEY] = ts
    attrs = definition.attributes
    for attr in attrs:
        if attr.name not in data:
            raise KeyError(f"column '{attr.name}' missing from batch")
    arrs: Dict[str, np.ndarray] = {}
    masks: Dict[str, np.ndarray] = {}
    scratch: Dict[str, np.ndarray] = {}
    srcs = {attr.name: np.asarray(data[attr.name]) for attr in attrs}
    str_obj = {attr.name: (attr.type == AttrType.STRING
                           and not np.issubdtype(srcs[attr.name].dtype,
                                                 np.integer))
               for attr in attrs}
    for attr in attrs:
        arrs[attr.name] = np.zeros(b, dtype_of(attr.type))
        masks[attr.name] = np.zeros(b, bool)
        if str_obj[attr.name]:
            scratch[attr.name] = np.empty(n, np.int64)

    def pack_chunk(lo: int, hi: int) -> None:
        if jt:
            journey.maybe_delay("pack")
        if ts_src is not None:
            ts[lo:hi] = ts_src[lo:hi]
        for attr in attrs:
            src = srcs[attr.name]
            if str_obj[attr.name]:
                scratch[attr.name][lo:hi] = dictionary.probe_array(
                    src[lo:hi])
            elif attr.type == AttrType.STRING:
                ids = np.asarray(src[lo:hi], np.int64)
                m = ids < 0           # pre-encoded: negative = null
                masks[attr.name][lo:hi] = m
                arrs[attr.name][lo:hi] = np.where(m, 0, ids)
            else:
                arrs[attr.name][lo:hi] = src[lo:hi]

    chunk_ms = pool.run_ordered(chunks, pack_chunk)
    t_merge = time.perf_counter()
    for attr in attrs:
        if str_obj[attr.name]:
            ids = scratch[attr.name]
            src = srcs[attr.name]
            dictionary.resolve_missing(ids, lambda i, _s=src: _s[i])
            mask = ids == StringDictionary.NULL_ID
            masks[attr.name][:n] = mask
            arrs[attr.name][:n] = np.where(mask, 0, ids)
        user_mask = data.get(attr.name + "?")
        if user_mask is not None:
            masks[attr.name][:n] |= np.asarray(user_mask, bool)[:n]
        cols[attr.name] = arrs[attr.name]
        cols[attr.name + "?"] = masks[attr.name]
    return _stamped(pool, HostBatch(cols), jt, chunk_ms, t_merge)
