"""Incremental (multi-granularity time-series) aggregation.

Counterpart of ``siddhi_tpu/core/aggregation/incremental.py``, host numpy
in both packages (reference ``aggregation/AggregationRuntime.java:81``,
``IncrementalExecutor.java:103-160``, ``BaseIncrementalValueStore`` and
the incremental aggregators sum, count, avg = sum+count, min, max,
distinctCount and the bare last-value selection). Each arriving chunk is
bucketized for every duration in one vectorized pass (numpy datetime64
truncation covers calendar months and years), then folded row by row
into per-duration bucket stores ``{duration: {bucket: {group: [bases]}}}``
in arrival order, exactly as the reference folds them, so float sums are
bit-equal between the packages. Query-time ``within``/``per`` stitches
the buckets of one duration into a columnar probe surface (``contents``)
for on-demand finds and aggregation joins.

A columnar ``receive_batch`` folds a junction batch without decoding it
to ``Event`` objects and back; it folds the same rows in the same order.

``@PartitionById`` shard mode publishes and stitches partial buckets
through the app's persistence store (``core/util/persistence.py``).

Each runtime registers per-granularity bucket-count gauges and a
fold-latency histogram (``aggregation.<id>.flush_ms``) on the app's
telemetry registry. The serving tier's sharded stores
(``siddhi_tpu.agg_shards`` > 1, ``serving/sharded_aggregation.py``)
subclass this runtime: one rollup program, the state split by key.

With a device-memory budget registered (``resilience/overload.py``) the
fold is gated as the reference gates it: the bucket stores grow a
(duration, bucket, group) slot for each new key, so a fold is denied
before it creates slots once the projected slot count passes the app's
budget, and the store is charged after it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.core.event import Event, HostBatch
from siddhi_tpu_torch.core.plan.resolvers import SingleStreamResolver
from siddhi_tpu_torch.core.stream.junction import Receiver
from siddhi_tpu_torch.ops.expressions import (
    NUMPY_XP, TS_KEY, TYPE_KEY, VALID_KEY, CompileError, compile_expr)
from siddhi_tpu_torch.query_api.definitions import (
    AggregationDefinition,
    Attribute,
    AttrType,
    Duration,
    StreamDefinition,
)
from siddhi_tpu_torch.query_api.expressions import AttributeFunction, Variable

AGG_TS = "AGG_TIMESTAMP"

_LOG = logging.getLogger("siddhi_tpu_torch.aggregation")

_DUR_ORDER = [Duration.SECONDS, Duration.MINUTES, Duration.HOURS, Duration.DAYS,
              Duration.MONTHS, Duration.YEARS]
_DUR_MS = {Duration.SECONDS: 1000, Duration.MINUTES: 60_000,
           Duration.HOURS: 3_600_000, Duration.DAYS: 86_400_000}
_DUR_NAMES = {
    "sec": Duration.SECONDS, "second": Duration.SECONDS, "seconds": Duration.SECONDS,
    "min": Duration.MINUTES, "minute": Duration.MINUTES, "minutes": Duration.MINUTES,
    "hour": Duration.HOURS, "hours": Duration.HOURS,
    "day": Duration.DAYS, "days": Duration.DAYS,
    "month": Duration.MONTHS, "months": Duration.MONTHS,
    "year": Duration.YEARS, "years": Duration.YEARS,
}


def parse_duration_name(name: str) -> Duration:
    d = _DUR_NAMES.get(name.strip().lower())
    if d is None:
        raise CompileError(f"unknown aggregation duration '{name}'")
    return d


_TIME_UNITS_MS = {
    "ms": 1, "millisecond": 1, "milliseconds": 1,
    "sec": 1000, "second": 1000, "seconds": 1000,
    "min": 60_000, "minute": 60_000, "minutes": 60_000,
    "h": 3600_000, "hour": 3600_000, "hours": 3600_000,
    "day": 86_400_000, "days": 86_400_000,
    "month": 31 * 86_400_000, "months": 31 * 86_400_000,
    "year": 366 * 86_400_000, "years": 366 * 86_400_000,
}


def _parse_time_str(s: str) -> Optional[int]:
    """'120 sec' / '24 hours' / 'all' -> milliseconds (None = keep all)."""
    s = s.strip().lower()
    if s == "all":
        return None
    parts = s.split()
    if len(parts) == 2 and parts[1] in _TIME_UNITS_MS:
        return int(float(parts[0]) * _TIME_UNITS_MS[parts[1]])
    if s.isdigit():
        return int(s)
    raise CompileError(f"cannot parse retention/interval time '{s}'")


def bucket_starts(ts_ms: np.ndarray, duration: Duration) -> np.ndarray:
    """Vectorized bucket-start (ms) per duration; months/years are
    calendar-truncated (reference ``executor/incremental/*`` time
    functions)."""
    ts_ms = np.asarray(ts_ms, np.int64)
    if duration in _DUR_MS:
        w = _DUR_MS[duration]
        return ts_ms - ts_ms % w
    dt = ts_ms.astype("datetime64[ms]")
    unit = "M" if duration == Duration.MONTHS else "Y"
    return dt.astype(f"datetime64[{unit}]").astype("datetime64[ms]").astype(np.int64)


class _BaseSpec:
    """One base accumulator column (reference BaseIncrementalValueStore
    fields): kind in sum/count/min/max; `out` names the stored column.
    ``arg_fn`` supplies both the value and the null mask — null rows leave
    the base untouched (reference incremental aggregators skip nulls)."""

    def __init__(self, kind: str, arg_fn, out: str, out_type: AttrType):
        self.kind = kind
        self.arg_fn = arg_fn
        self.out = out
        self.out_type = out_type

    def fold(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        if self.kind in ("sum", "count"):
            return a + b
        if self.kind == "distinct":
            return a | b          # sets of observed values
        if self.kind == "last":
            # bare selections keep the value of the LATEST event TIME in
            # the bucket — an out-of-order arrival with an older timestamp
            # must not displace it (LatestAggregationTestCase test1);
            # slots are (event_ts, value) pairs. Bare values from snapshots
            # or shard blobs written before the pair layout sort oldest.
            if not isinstance(a, tuple):
                a = (-2 ** 62, a)
            if not isinstance(b, tuple):
                b = (-2 ** 62, b)
            return b if b[0] >= a[0] else a
        return min(a, b) if self.kind == "min" else max(a, b)


class _OutSpec:
    """One selected output: computed from base columns at query time."""

    def __init__(self, name: str, kind: str, bases: List[str], out_type: AttrType):
        self.name = name
        self.kind = kind      # 'sum'|'count'|'avg'|'min'|'max'|'group'
        self.bases = bases    # base column names (avg: [sum, count])
        self.out_type = out_type


class IncrementalAggregationRuntime(Receiver):
    def __init__(self, definition: AggregationDefinition, app_context,
                 dictionary, stream_definitions: Dict[str, StreamDefinition]):
        self.definition = definition
        self.app_context = app_context
        self.dictionary = dictionary
        self._lock = threading.RLock()

        s = definition.input_stream
        sid = s.unique_stream_id if hasattr(s, "unique_stream_id") else s.stream_id
        if sid not in stream_definitions:
            raise CompileError(f"aggregation '{definition.id}': stream '{sid}' undefined")
        self.input_def = stream_definitions[sid]
        self.input_stream_id = sid
        resolver = SingleStreamResolver(self.input_def, dictionary)

        # time attribute (`aggregate by attr`, default: event timestamp);
        # STRING attributes carry 'yyyy-MM-dd HH:mm:ss [±HH:MM]' dates,
        # parsed per event — unparsable rows are dropped with a log, not
        # raised (reference IncrementalUnixTimeFunctionExecutor +
        # Aggregation1TestCase test16/test38)
        self.ts_is_string = False
        self._ts_memo: Dict[int, Optional[int]] = {}
        if definition.aggregate_attribute is not None:
            fn, t = compile_expr(definition.aggregate_attribute, resolver)
            if t == AttrType.STRING:
                self.ts_is_string = True
            elif t not in (AttrType.LONG, AttrType.INT):
                raise CompileError(
                    "aggregate by attribute must be long (ms epoch) or a "
                    "'yyyy-MM-dd HH:mm:ss' string")
            self.ts_fn = fn
        else:
            self.ts_fn = None

        # durations
        tp = definition.time_period
        if tp is None or not tp.durations:
            raise CompileError("aggregation needs `every <durations>`")
        if tp.operator == "range":
            lo = _DUR_ORDER.index(tp.durations[0])
            hi = _DUR_ORDER.index(tp.durations[-1])
            self.durations = _DUR_ORDER[lo: hi + 1]
        else:
            self.durations = sorted(set(tp.durations), key=_DUR_ORDER.index)

        # selector -> group keys + base/output specs
        sel = definition.selector
        self.group_fns = []
        self.group_attrs: List[Attribute] = []
        for v in (sel.group_by_list or []):
            fn, t = compile_expr(v, resolver)
            self.group_fns.append(fn)
            self.group_attrs.append(Attribute(v.attribute_name, t))

        self.bases: Dict[str, _BaseSpec] = {}
        self.outputs: List[_OutSpec] = []
        group_names = {a.name for a in self.group_attrs}
        for oa in sel.selection_list:
            expr = oa.expression
            name = oa.name
            if isinstance(expr, Variable) and expr.attribute_name in group_names:
                self.outputs.append(_OutSpec(
                    name, "group", [expr.attribute_name],
                    next(a.type for a in self.group_attrs
                         if a.name == expr.attribute_name)))
                continue
            kind = expr.name.lower() if isinstance(expr, AttributeFunction) \
                else None
            if kind not in ("sum", "count", "avg", "min", "max",
                            "distinctcount"):
                # bare expression (`(price * quantity) as lastTradeValue`):
                # the LATEST arrival's value per (bucket, group) — reference
                # AggregationParser keeps non-aggregate selections with
                # last-value semantics (Aggregation1TestCase test5; null
                # arguments leave the stored value untouched)
                arg_fn, arg_t = compile_expr(expr, resolver)
                base = self._base(f"last@{name}", arg_fn, arg_t, kind="last")
                self.outputs.append(_OutSpec(name, "last", [base], arg_t))
                continue
            arg_fn, arg_t = (compile_expr(expr.parameters[0], resolver)
                             if expr.parameters else (None, None))
            if kind == "count":
                base = self._base("count", None, AttrType.LONG)
                self.outputs.append(_OutSpec(name, "count", [base], AttrType.LONG))
            elif kind == "distinctcount":
                # per-bucket per-group value sets (reference
                # IncrementalAggregateBaseTimeFunctions distinct-count)
                base = self._base(f"distinct@{name}", arg_fn, AttrType.LONG,
                                  kind="distinct")
                self.outputs.append(_OutSpec(name, "distinctcount", [base],
                                             AttrType.LONG))
            elif kind == "avg":
                bs = self._base(f"sum@{name}", arg_fn, AttrType.DOUBLE)
                # avg counts only non-null argument rows, so its count base
                # carries the argument (for the null mask), unlike count()
                bc = self._base(f"cnt@{name}", arg_fn, AttrType.LONG,
                                kind="count")
                self.outputs.append(_OutSpec(name, "avg", [bs, bc], AttrType.DOUBLE))
            elif kind == "sum":
                t = AttrType.LONG if arg_t in (AttrType.INT, AttrType.LONG) else AttrType.DOUBLE
                base = self._base(f"sum@{name}", arg_fn, t)
                self.outputs.append(_OutSpec(name, "sum", [base], t))
            else:  # min / max
                base = self._base(f"{kind}@{name}", arg_fn, arg_t)
                self.outputs.append(_OutSpec(name, kind, [base], arg_t))

        # per-duration bucket stores:
        #   {duration: {bucket_start: {group_tuple: [base values]}}}
        self.store: Dict[Duration, Dict[int, Dict[tuple, list]]] = {
            d: {} for d in self.durations
        }
        # incremental-snapshot bookkeeping: buckets touched/purged since
        # the last checkpoint (reference IncrementalSnapshotable op-logs)
        self._dirty: set = set()
        self._deleted: set = set()

        # @purge retention (reference IncrementalDataPurger.java:62):
        # per-duration retention windows; coarser durations retain the
        # history the purged finer buckets summarized
        from siddhi_tpu_torch.query_api.annotations import find_annotation

        purge_ann = find_annotation(definition.annotations or [], "purge")
        self.purge_enabled = False
        self.purge_interval_ms = 15 * 60 * 1000
        self.retention: Dict[Duration, Optional[int]] = {}
        if purge_ann is not None:
            self.purge_enabled = (purge_ann.element("enable") or "true").lower() == "true"
            interval = purge_ann.element("interval")
            if interval:
                self.purge_interval_ms = _parse_time_str(interval)
            # reference defaults (IncrementalDataPurger): fine granularities
            # age out fast, coarse ones are kept
            self.retention = {
                Duration.SECONDS: 120_000,
                Duration.MINUTES: 24 * 3600_000,
                Duration.HOURS: 30 * 24 * 3600_000,
                Duration.DAYS: 366 * 24 * 3600_000,
                Duration.MONTHS: None,
                Duration.YEARS: None,
            }
            rp = purge_ann.annotation("retentionPeriod")
            if rp is not None:
                for k, v in rp.elements:
                    if k is None:
                        continue
                    self.retention[parse_duration_name(k)] = _parse_time_str(v)

        # @PartitionById distributed (shard) mode: this runtime aggregates
        # only its shard's events; rows are tagged so a reader can stitch
        # shards (reference AggregationParser.java:171-197 shardId columns)
        pbi = find_annotation(definition.annotations or [], "PartitionById")
        cm = getattr(app_context.siddhi_context, "config_manager", None)
        ann_enabled = pbi is not None and (
            (pbi.element("enable") or "true").lower() == "true")
        sys_enabled = ((cm.get_property("partitionById") or "")
                       if cm is not None else "").lower() == "true"
        # the `partitionById` system property enables shard mode even when
        # the annotation disables it (Aggregation2TestCase test55/56)
        self.shard_mode = ann_enabled or sys_enabled
        self.shard_id = None
        if self.shard_mode:
            cfg = cm.get_property("shardId") if cm is not None else None
            if not cfg:
                # the reference requires a configured shardId
                # (AggregationParser.java:173-186; Aggregation2TestCase
                # test52/53 expect creation to fail without one)
                raise CompileError(
                    f"aggregation '{definition.id}': @PartitionById needs a "
                    f"configured 'shardId' property")
            self.shard_id = cfg

        # /metrics: per-granularity bucket-count gauges and a fold-latency
        # histogram, on the app's always-on telemetry registry (the sharded
        # serving runtime is scraped the same way)
        self._flush_hist = None
        tel = getattr(app_context, "telemetry", None)
        if tel is not None:
            aid = definition.id
            for d in self.durations:
                tel.gauge(f"aggregation.{aid}.{d.value}.buckets",
                          lambda d=d: self._bucket_count(d))
            self._flush_hist = tel.histogram(f"aggregation.{aid}.flush_ms")

    def _bucket_count(self, duration: Duration) -> int:
        """Live bucket count for one granularity (telemetry gauge); the
        sharded serving runtime sums its shards."""
        return len(self.store.get(duration, ()))

    def purge(self, now: Optional[int] = None) -> int:
        """Drop buckets older than each duration's retention; returns the
        number of purged buckets (reference IncrementalDataPurger run)."""
        if now is None:
            now = int(self.app_context.timestamp_generator.current_time())
        purged = 0
        with self._lock:
            for d, dstore in self.store.items():
                keep_ms = self.retention.get(d)
                if keep_ms is None:
                    continue
                cutoff = now - keep_ms
                drop = [b for b in dstore if b < cutoff]
                for b in drop:
                    del dstore[b]
                    self._deleted.add((d, b))
                    self._dirty.discard((d, b))
                purged += len(drop)
        return purged

    # ----------------------------------------------- incremental snapshots

    def incremental_snapshot(self) -> dict:
        """Buckets touched since the last checkpoint (+ purge tombstones).
        Pure capture — the op log is cleared only after the checkpoint is
        durably saved (``clear_oplog``), so a failed save loses nothing."""
        with self._lock:
            out = {"buckets": {}, "deleted": []}
            for d, b in self._dirty:
                groups = self.store.get(d, {}).get(b)
                if groups is None:
                    continue
                out["buckets"].setdefault(d.value, {})[b] = {
                    g: list(v) for g, v in groups.items()}
            out["deleted"] = [(d.value, b) for d, b in self._deleted]
            return out

    def clear_oplog(self):
        with self._lock:
            self._dirty.clear()
            self._deleted.clear()

    def apply_increment(self, snap: dict):
        with self._lock:
            # deletions first: a bucket purged then re-created within one
            # checkpoint interval appears in both lists and must survive
            for dv, b in snap.get("deleted", []):
                self.store.get(Duration(dv), {}).pop(b, None)
            for dv, buckets in snap.get("buckets", {}).items():
                d = Duration(dv)
                dstore = self.store.setdefault(d, {})
                for b, groups in buckets.items():
                    dstore[b] = {g: list(v) for g, v in groups.items()}

    def _base(self, key: str, arg_fn, out_type, kind: Optional[str] = None) -> str:
        if key not in self.bases:
            if kind is None:
                kind = key.split("@")[0]
            self.bases[key] = _BaseSpec(kind, arg_fn, key, out_type)
        return key

    # ------------------------------------------------------------- ingest

    def receive(self, events: List[Event]):
        batch = HostBatch.from_events(events, self.input_def, self.dictionary)
        self._fold_batch(batch.cols)

    def receive_batch(self, batch, junction=None):
        """Columnar path: the junction's batch folds as it is (the rows
        ``receive`` would rebuild from its decoded events, in order)."""
        self._fold_batch(batch.cols)

    def _fold_batch(self, cols) -> None:
        prep = self._prepare_batch(cols)
        if prep is None:
            return
        t0 = time.perf_counter()
        with self._lock:
            self._fold_rows(self, prep, prep["idx"])
        if self._flush_hist is not None:
            self._flush_hist.record((time.perf_counter() - t0) * 1000.0)

    def _prepare_batch(self, cols) -> Optional[dict]:
        """Run the compiled rollup program over one batch's host columns:
        timestamps, group keys, base argument columns and per-duration
        bucket starts — everything that is independent of which store the
        rows fold into."""
        cols = {k: cols[k] for k in list(cols)}   # one host read
        ctx = {"xp": NUMPY_XP}
        valid = cols[VALID_KEY] & (cols[TYPE_KEY] == 0)
        idx = np.nonzero(valid)[0]
        if idx.size == 0:
            return None
        if self.ts_fn is not None:
            tsv, _m = self.ts_fn(cols, ctx)
            if self.ts_is_string:
                from siddhi_tpu_torch.core.aggregation.within_time import unix_ms

                ids = np.broadcast_to(np.asarray(tsv, np.int64), valid.shape)
                tsv = np.zeros(valid.shape, np.int64)
                ok = np.zeros(valid.shape, bool)
                for j in idx:
                    i = int(ids[j])
                    if i not in self._ts_memo:
                        s = self.dictionary.decode(i)
                        try:
                            self._ts_memo[i] = unix_ms(s) if s else None
                        except Exception:
                            self._ts_memo[i] = None
                        if self._ts_memo[i] is None:
                            _LOG.warning(
                                "aggregation '%s': '%s' doesn't match the "
                                "supported formats <yyyy>-<MM>-<dd> "
                                "<HH>:<mm>:<ss> (GMT) or with a <Z> offset; "
                                "dropping event", self.definition.id, s)
                    ms = self._ts_memo[i]
                    if ms is not None:
                        tsv[j] = ms
                        ok[j] = True
                valid = valid & ok
                idx = np.nonzero(valid)[0]
                if idx.size == 0:
                    return None
            else:
                tsv = np.broadcast_to(np.asarray(tsv, np.int64), valid.shape)
        else:
            tsv = np.asarray(cols[TS_KEY], np.int64)

        groups = []
        for fn in self.group_fns:
            v, _m = fn(cols, ctx)
            groups.append(np.broadcast_to(np.asarray(v), valid.shape))
        base_vals = {}
        base_null = {}
        for key, spec in self.bases.items():
            if spec.arg_fn is None:
                base_vals[key] = np.ones(valid.shape, np.int64)
                base_null[key] = None
            else:
                v, m = spec.arg_fn(cols, ctx)
                if spec.kind == "count":
                    base_vals[key] = np.ones(valid.shape, np.int64)
                else:
                    base_vals[key] = np.broadcast_to(np.asarray(v), valid.shape)
                base_null[key] = (np.broadcast_to(np.asarray(m), valid.shape)
                                  if m is not None else None)

        return {
            "idx": idx,
            "tsv": tsv,
            "groups": groups,
            # one group tuple per row (the values ``.item()`` gives)
            "group_tuples": (list(zip(*[x.tolist() for x in groups])) if groups
                             else [()] * valid.shape[0]),
            "base_vals": base_vals,
            "base_null": base_null,
            "buckets": {d: bucket_starts(tsv, d) for d in self.durations},
            # the host columns the program read (the sharded runtime's
            # per-shard WAL records its rows of them)
            "cols": cols,
        }

    def _host_lists(self, prep: dict) -> dict:
        """The prepared columns as Python lists (``tolist`` gives the values
        ``.item()`` gives), made once a batch: the sharded runtime folds
        one batch into several shards."""
        lists = prep.get("lists")
        if lists is None:
            base_keys = list(self.bases)
            lists = prep["lists"] = {
                "tsv": prep["tsv"].tolist(),
                "vals": [prep["base_vals"][k].tolist() for k in base_keys],
                "nulls": [None if prep["base_null"][k] is None
                          else prep["base_null"][k].tolist() for k in base_keys],
                "buckets": {d: prep["buckets"][d].tolist() for d in self.durations},
            }
        return lists

    def _fold_rows(self, holder, prep: dict, rows) -> None:
        """Fold prepared rows into ``holder``'s bucket stores (``store``,
        ``_dirty``, ``_deleted``: this runtime, or one ``AggregationShard``
        of the serving tier); the caller holds the holder's lock. With a
        memory budget the fold is gated first and charged after."""
        ctl = getattr(self.app_context, "overload", None)
        if ctl is not None and ctl.memory_budget_bytes is not None:
            # the device-memory budget gate (resilience/overload.py): the
            # stores grow a (duration, bucket, group) slot a new key, so the
            # fold is denied before it creates slots once the app's budget
            # is spent. The O(slots) scan runs only under a budget
            from siddhi_tpu_torch.resilience.overload import (
                charge_memory,
                ensure_memory_budget,
            )

            comp = self._budget_component(holder)
            per_slot = 96 + 56 * max(len(self.bases), 1)
            est = self._approx_store_slots(holder) * per_slot
            ensure_memory_budget(
                self.app_context, comp,
                est + len(rows) * len(self.durations) * per_slot,
                what=f"aggregation '{self.definition.id}' bucket-store growth")
            self._fold_rows_inner(holder, prep, rows)
            charge_memory(self.app_context, comp,
                          self._approx_store_slots(holder) * per_slot)
            return
        self._fold_rows_inner(holder, prep, rows)

    def _budget_component(self, holder) -> str:
        idx = getattr(holder, "index", None)
        base = f"aggregation.{self.definition.id}"
        return base if holder is self or idx is None else f"{base}.shard{idx}"

    @staticmethod
    def _approx_store_slots(holder) -> int:
        """(duration, bucket, group) slots: the unit the memory budget
        charges bucket stores by (approximate: slot boxes dominate the
        host-dict footprint)."""
        return sum(len(groups) for dstore in holder.store.values()
                   for groups in dstore.values())

    def _fold_rows_inner(self, holder, prep: dict, rows) -> None:
        """Row by row and base by base in arrival order, as the reference
        folds (``_fold_rows_inner``)."""
        base_keys = list(self.bases)
        kinds = [self.bases[k].kind for k in base_keys]
        folds = [self.bases[k].fold for k in base_keys]
        lists = self._host_lists(prep)
        tsv, vals, nulls = lists["tsv"], lists["vals"], lists["nulls"]
        group_tuples = prep["group_tuples"]
        rows = [int(i) for i in rows]
        nb = len(base_keys)
        dirty, deleted = holder._dirty, holder._deleted
        for d in self.durations:
            buckets = lists["buckets"][d]
            # setdefault: a restore may have replaced the store with a
            # snapshot keeping fewer granularities — ingest re-creates
            # the declared ones rather than crashing
            dstore = holder.store.setdefault(d, {})
            for i in rows:
                b = buckets[i]
                g = group_tuples[i]
                dirty.add((d, b))
                deleted.discard((d, b))   # re-created after purge
                groups = dstore.get(b)
                if groups is None:
                    groups = dstore[b] = {}
                slot = groups.get(g)
                if slot is None:
                    slot = groups[g] = [None] * nb
                for j in range(nb):
                    nm = nulls[j]
                    if nm is not None and nm[i]:
                        continue  # null arg leaves the base untouched
                    v = vals[j][i]
                    cur = slot[j]
                    kind = kinds[j]
                    if kind == "distinct":
                        slot[j] = folds[j](cur, {v})
                    elif kind == "last":
                        slot[j] = folds[j](cur, (tsv[i], v))  # event-time-tagged
                    elif cur is None:
                        slot[j] = v
                    elif kind == "sum" or kind == "count":
                        slot[j] = cur + v
                    elif kind == "min":
                        slot[j] = min(cur, v)
                    else:
                        slot[j] = max(cur, v)

    # -------------------------------------------------------------- query

    def output_definition(self) -> StreamDefinition:
        attrs = [Attribute(AGG_TS, AttrType.LONG)]
        seen = {AGG_TS}
        for o in self.outputs:
            if o.name not in seen:
                attrs.append(Attribute(o.name, o.out_type))
                seen.add(o.name)
        for a in self.group_attrs:
            if a.name not in seen:
                attrs.append(a)
                seen.add(a.name)
        return StreamDefinition(id=self.definition.id, attributes=attrs)

    def _resolve_within(self, duration: Duration,
                        within: Optional[Tuple[int, int]]):
        # checked against the STORE, not self.durations: a restore may
        # have replaced the store with a snapshot keeping fewer (or more)
        # granularities, and the queryable set follows the state
        if duration not in self.store:
            raise CompileError(
                f"aggregation '{self.definition.id}' does not keep "
                f"'{duration.value}' granularity")
        if within is not None:
            # the reference truncates the within-START down to the queried
            # duration's bucket start (IncrementalTimeConverterUtil via
            # IncrementalAggregateCompileCondition): a range falling inside
            # one bucket still selects that bucket (Aggregation1TestCase
            # test44: a 1-second range read `per "hours"`)
            start = int(bucket_starts(np.asarray([within[0]]), duration)[0])
            within = (start, within[1])
        return within

    def _rows_from_items(self, items) -> List[list]:
        """Compute the final output rows from (bucket, group, base-values)
        items — ONE code path shared by the single-store read and the
        serving tier's cross-shard stitched read, so sharded and unsharded
        results are computed bit-identically."""
        base_keys = list(self.bases)
        out_rows: List[list] = []
        onames = {o.name for o in self.outputs}
        gnames = [a.name for a in self.group_attrs]
        for b, g, vals in items:
            by_key = dict(zip(base_keys, vals))
            row = [b]
            for o in self.outputs:
                if o.kind == "group":
                    row.append(g[gnames.index(o.bases[0])])
                elif o.kind == "avg":
                    s, c = by_key[o.bases[0]], by_key[o.bases[1]]
                    row.append(s / c if (c and s is not None) else None)
                elif o.kind == "count":
                    row.append(by_key[o.bases[0]] or 0)
                elif o.kind == "distinctcount":
                    s = by_key[o.bases[0]]
                    row.append(len(s) if s else 0)
                elif o.kind == "last":
                    v = by_key[o.bases[0]]  # (event_ts, value) pair
                    # bare pre-pair-layout snapshot values pass through
                    row.append(v[1] if isinstance(v, tuple) else v)
                else:
                    row.append(by_key[o.bases[0]])  # None -> null output
            for gi, a in enumerate(self.group_attrs):
                if a.name not in onames:
                    row.append(g[gi])
            out_rows.append(row)
        return out_rows

    def rows(self, duration: Duration,
             within: Optional[Tuple[int, int]] = None) -> List[list]:
        """Final (stitched) rows for one duration: [AGG_TS, outputs...,
        group attrs...] — closed and open buckets alike (the reference's
        table + running-store stitch)."""
        within = self._resolve_within(duration, within)
        items = []
        with self._lock:
            for b in sorted(self.store[duration]):
                if within is not None and not (within[0] <= b < within[1]):
                    continue
                for g, vals in self.store[duration][b].items():
                    items.append((b, g, list(vals)))
        return self._rows_from_items(items)

    def contents(self, duration: Duration,
                 within: Optional[Tuple[int, int]] = None):
        """Columnar probe surface over the stitched buckets of one
        duration: (output_definition, cols, valid) — shared by on-demand
        `within/per` queries and aggregation joins (reference
        ``AggregationRuntime.java:331-357`` compiled selection)."""
        return self._columnize(self.rows(duration, within))

    def _columnize(self, rows: List[list]):
        """Rows -> (output_definition, columnar numpy arrays, valid mask) —
        the probe surface shape shared with tables/named windows."""
        from siddhi_tpu_torch.ops.expressions import TS_KEY
        from siddhi_tpu_torch.ops.types import dtype_of

        definition = self.output_definition()
        n = len(rows)
        # pad to the next power of two: the on-demand selector stage jits
        # per columnar SHAPE, and under live ingest the stitched row count
        # moves with every fold — raw-n capacity meant a recompile per
        # query, pow2 padding means a handful of shapes per query text
        # (padding rows stay valid=False, exactly like table capacity)
        cap = 1
        while cap < n:
            cap *= 2
        cols = {}
        for pos, attr in enumerate(definition.attributes):
            dt = dtype_of(attr.type)
            arr = np.zeros(cap, dt)
            mask = np.zeros(cap, bool)
            for i, r in enumerate(rows):
                v = r[pos]
                if v is None:
                    mask[i] = True
                else:
                    arr[i] = v
            cols[attr.name] = arr
            cols[attr.name + "?"] = mask
        cols[TS_KEY] = cols[definition.attributes[0].name]  # AGG_TIMESTAMP
        valid = np.arange(cap) < n
        return definition, cols, valid

    # ------------------------------------------------- distributed shards

    def _shard_store(self):
        store = self.app_context.siddhi_context.persistence_store
        if store is None:
            raise RuntimeError(
                "@PartitionById aggregation needs a shared persistence "
                "store — call SiddhiManager.set_persistence_store(...)")
        return store

    @property
    def _shard_ns(self) -> str:
        return f"aggregation-shards:{self.definition.id}"

    def _group_codec(self):
        """(encode, decode) for group-key tuples: STRING components travel
        as text between shards (each node has its OWN dictionary, so raw
        ids don't align across runtimes)."""
        str_pos = [i for i, a in enumerate(self.group_attrs)
                   if a.type == AttrType.STRING]
        dic = self.app_context.string_dictionary

        def decode(g):
            return tuple(dic.decode(int(v)) if i in str_pos else v
                         for i, v in enumerate(g))

        def encode(g):
            return tuple(dic.encode(v) if i in str_pos else v
                         for i, v in enumerate(g))

        return encode, decode

    def publish_shard(self):
        """Shard mode: publish this node's partial buckets to the shared
        persistence store under its shardId — the TPU-native analog of
        the reference writing per-``shardId``-keyed rows into shared
        aggregation tables (AggregationParser.java:171-197). Idempotent:
        each publish overwrites this shard's previous rows. String group
        keys are decoded to text (dictionaries are per-node)."""
        import pickle

        if not self.shard_mode:
            raise RuntimeError(
                f"aggregation '{self.definition.id}' is not @PartitionById")
        _enc, dec = self._group_codec()
        with self._lock:
            snap = self.snapshot()
        snap["store"] = {
            dv: {b: {dec(tuple(g) if isinstance(g, (list, tuple)) else (g,)):
                     v for g, v in groups.items()}
                 for b, groups in dstore.items()}
            for dv, dstore in snap["store"].items()
        }
        blob = pickle.dumps(snap, protocol=pickle.HIGHEST_PROTOCOL)
        self._shard_store().save(self._shard_ns, f"shard-{self.shard_id}",
                                 blob)

    def stitch_shards(self) -> int:
        """Reader side: fold every published shard's partial bases into
        this runtime's store (sum/count add, min/min, max/max, distinct
        sets union — ``_BaseSpec.fold``), REPLACING local buckets. The
        role of the reference's cross-shard aggregation table reads
        (``IncrementalAggregateCompileCondition`` over shardId-keyed
        tables). Returns the number of shards merged."""
        from siddhi_tpu_torch.core.util.snapshot import safe_loads

        store = self._shard_store()
        shard_revs = [r for r in store.revisions(self._shard_ns)
                      if r.startswith("shard-")]
        base_keys = list(self.bases)
        merged: Dict[Duration, Dict[int, Dict[tuple, list]]] = {
            d: {} for d in self.durations}
        enc, _dec = self._group_codec()
        for rev in sorted(shard_revs):
            snap = safe_loads(store.load(self._shard_ns, rev))
            snap_keys = snap.get("base_keys", base_keys)
            for dv, dstore in snap["store"].items():
                d = parse_duration_name(dv)
                if d not in merged:
                    continue
                for b, groups in dstore.items():
                    buckets = merged[d].setdefault(int(b), {})
                    for g, vals in groups.items():
                        key = enc(tuple(g) if isinstance(g, (list, tuple))
                                  else (g,))
                        by = dict(zip(snap_keys, vals))
                        cur = buckets.get(key)
                        if cur is None:
                            cur = buckets[key] = [None] * len(base_keys)
                        for i, k in enumerate(base_keys):
                            cur[i] = self.bases[k].fold(cur[i], by.get(k))
        with self._lock:
            self.store = merged
        return len(shard_revs)

    # --------------------------------------------------------- persistence

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "base_keys": list(self.bases),
                "store": {
                    d.value: {b: {g: list(v) for g, v in groups.items()}
                              for b, groups in dstore.items()}
                    for d, dstore in self.store.items()
                }
            }

    def _merge_sharded_snapshot(self, snap: dict) -> dict:
        """Fold a serving-tier sharded snapshot ({"sharded": True,
        "shards": [...]}) into one flat store dict — the shard-stitch rule
        (``_BaseSpec.fold`` per base) applied at restore time, so
        pre-sharding and post-sharding revisions cross-restore in both
        directions."""
        snap_keys = snap.get("base_keys", list(self.bases))
        store: dict = {}
        for shard_snap in snap.get("shards", []):
            for dv, dstore in shard_snap.get("store", {}).items():
                dd = store.setdefault(dv, {})
                for b, groups in dstore.items():
                    bg = dd.setdefault(b, {})
                    for g, vals in groups.items():
                        cur = bg.get(g)
                        if cur is None:
                            bg[g] = list(vals)
                        else:  # duplicate (bucket, group): fold the bases
                            bg[g] = [
                                self.bases[k].fold(a, v)
                                if k in self.bases
                                else (v if v is not None else a)
                                for k, a, v in zip(snap_keys, cur, vals)]
        return {"base_keys": snap_keys, "store": store}

    def restore(self, snap: dict):
        if snap.get("sharded"):
            snap = self._merge_sharded_snapshot(snap)
        # realign slot lists by base-key name so snapshots survive base
        # layout changes (e.g. avg gaining a cnt@ base)
        snap_keys = snap.get("base_keys")
        cur_keys = list(self.bases)
        if snap_keys is None or snap_keys == cur_keys:
            remap = None
        else:
            remap = [snap_keys.index(k) if k in snap_keys else -1
                     for k in cur_keys]

        def realign(v):
            if remap is None:
                return list(v)
            return [v[j] if j >= 0 else None for j in remap]

        with self._lock:
            self.store = {
                parse_duration_name(dv): {
                    int(b): {tuple(g) if isinstance(g, (list, tuple)) else (g,): realign(v)
                             for g, v in groups.items()}
                    for b, groups in dstore.items()
                }
                for dv, dstore in snap["store"].items()
            }
