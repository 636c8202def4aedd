"""Mesh-sharded incremental aggregation: the serving tier's write side.

Counterpart of ``siddhi_tpu/serving/sharded_aggregation.py``. The
reference's only multi-node aggregation story shards through a shared
database (``AggregationParser.java:171-197``, ``@PartitionById`` here);
this module shards in process instead:

- **One rollup program, N shards.** ``ShardedIncrementalAggregation``
  compiles the aggregation's selector, base and output specs once (the
  base-class constructor) and key-partitions only the state: each
  ``AggregationShard`` owns the bucket stores of its slice of the
  group-key space.
- **Routing.** A group tuple's owner is ``crc32(repr(key)) % n_shards``,
  the reference's rule byte for byte: the components are Python ints and
  floats (string groups as dictionary ids), so a (bucket, group) sits on
  the same shard in both packages. A junction batch is prepared once
  (``_prepare_batch``: the port folds a batch column-wise), its rows are
  routed once, and each shard folds its rows in arrival order under its
  own lock, so two shards never contend.
- **Snapshot reads.** Queries read per-shard partials: an epoch-pinned
  copy of the shard's buckets, cached until the next fold bumps the epoch.
  Each shard also keeps its rows as columnar tensors on the runtime's
  device (``shard_device_contents``). On one card every logical shard's
  device is that card, as ``parallel/mesh.py`` places logical shards.
- **Ordered merge.** ``rows()`` scatter-gathers the shards' partials and
  stitches them with a deterministic k-way merge by (bucket, group),
  folding duplicates with ``_BaseSpec.fold``; the output rows come from
  the base class's ``_rows_from_items``, so sharded and unsharded results
  are bit-identical.
- **Per-shard WALs and rebuild.** Each shard records its rows of every
  batch (an owned copy of the prepared host columns) in its own bounded
  ``IngestWAL``; ``checkpoint_shards`` cuts and trims them, and
  ``rebuild_shard`` restores a lost shard from its last blob plus the WAL
  suffix, re-folding the recorded rows exactly as they were folded. A
  blob whose cut predates the WAL's last trim is restored without replay
  (the stale-revision rule).

Enable with the ``siddhi_tpu.agg_shards`` config key (> 1);
``@PartitionById`` keeps the single-store runtime.
"""

from __future__ import annotations

import heapq
import logging
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.analysis.locks import make_lock
from siddhi_tpu_torch.core.aggregation.incremental import (
    IncrementalAggregationRuntime,
    parse_duration_name,
)
from siddhi_tpu_torch.query_api.definitions import Duration

_LOG = logging.getLogger("siddhi_tpu_torch.serving")

# distinct group tuples whose owner is remembered (then the memo restarts)
_OWNER_CACHE_MAX = 1 << 20


def _merge_key(item):
    return item[0], item[1]


class AggregationShard:
    """One key range's multi-granularity bucket stores.

    Owns the ``{Duration: {bucket: {group: [bases]}}}`` layout of the
    single-store runtime plus a monotonically increasing ``epoch`` (bumped
    on every fold, purge and restore) that pins snapshot reads:
    ``partials()`` and the device view are cached per (duration, epoch)."""

    def __init__(self, index: int, durations: List[Duration], device=None,
                 wal=None):
        self.index = index
        self.device = device
        self.durations = durations
        self.store: Dict[Duration, Dict[int, Dict[tuple, list]]] = {
            d: {} for d in durations}
        self._dirty: set = set()
        self._deleted: set = set()
        self._lock = make_lock("shard")
        self.epoch = 0
        self.wal = wal
        # duration -> (epoch, sorted [(bucket, group, [bases copy])])
        self._partials_cache: Dict[Duration, Tuple[int, list]] = {}
        # duration -> (epoch, (definition, device cols, device valid))
        self._device_cache: Dict[Duration, Tuple[int, tuple]] = {}

    def bump(self) -> None:
        """Invalidate snapshot views; call under ``_lock`` after any
        store mutation."""
        self.epoch += 1

    def partials(self, duration: Duration) -> list:
        """Epoch-pinned snapshot of this shard's buckets for one duration:
        a sorted list of (bucket, group, base-values copy). Readers share
        the cached copy; a concurrent fold builds new slots but never
        mutates a handed-out copy."""
        with self._lock:
            cached = self._partials_cache.get(duration)
            if cached is not None and cached[0] == self.epoch:
                return cached[1]
            # .get: after a cross-layout restore a shard re-creates a
            # declared duration only when ingest first touches it
            items = [(b, g, list(vals))
                     for b, groups in self.store.get(duration, {}).items()
                     for g, vals in groups.items()]
            items.sort(key=_merge_key)
            self._partials_cache[duration] = (self.epoch, items)
            return items

    def wipe(self) -> None:
        """Fault injection: lose this shard's state. ``rebuild_shard``
        recovers it."""
        with self._lock:
            self.store = {d: {} for d in self.durations}
            self._dirty.clear()
            self._deleted.clear()
            self._partials_cache.clear()
            self._device_cache.clear()
            self.bump()


class ShardedIncrementalAggregation(IncrementalAggregationRuntime):
    def __init__(self, definition, app_context, dictionary,
                 stream_definitions, n_shards: int,
                 wal_batches: Optional[int] = 1024):
        super().__init__(definition, app_context, dictionary,
                         stream_definitions)
        if self.shard_mode:
            raise ValueError(
                f"aggregation '{definition.id}': @PartitionById DB-stitch "
                f"mode and in-process mesh sharding are mutually exclusive "
                f"(MIGRATION.md)")
        if n_shards < 1:
            raise ValueError("agg_shards must be >= 1")
        self.n_shards = int(n_shards)
        from siddhi_tpu_torch.resilience.replay import IngestWAL

        device = getattr(app_context, "device", None)
        self.shards: List[AggregationShard] = []
        for i in range(self.n_shards):
            wal = (IngestWAL(max_batches=wal_batches, app_context=app_context)
                   if wal_batches else None)
            self.shards.append(AggregationShard(
                i, self.durations, device=device, wal=wal))
        self._last_cuts: List[int] = [0] * self.n_shards
        # group tuple -> owner: crc32 once per distinct group
        self._owners: Dict[tuple, int] = {}

        tel = getattr(app_context, "telemetry", None)
        self._fanout_hist = self._merge_hist = None
        self._query_hists: Dict[Duration, object] = {}
        if tel is not None:
            aid = definition.id
            tel.gauge(f"aggregation.{aid}.shards", lambda: self.n_shards)
            for s in self.shards:
                if s.wal is not None:
                    tel.gauge(f"aggregation.{aid}.shard{s.index}.wal_batches",
                              s.wal.__len__)
            self._fanout_hist = tel.histogram("serving.fanout_ms")
            self._merge_hist = tel.histogram("serving.merge_ms")
            self._query_hists = {
                d: tel.histogram(f"serving.query.{d.value}_ms")
                for d in self.durations}

    # ------------------------------------------------------------- routing

    def _owner_of(self, g: tuple) -> int:
        """Deterministic shard owner of one group tuple, the reference's
        ``crc32(repr(g)) % n``: the components are Python ints and floats
        (``tolist``), never numpy or torch scalars, whose ``repr`` differs.
        WAL and snapshot recovery re-route through this same function."""
        if self.n_shards == 1:
            return 0
        owner = self._owners.get(g)
        if owner is None:
            if len(self._owners) >= _OWNER_CACHE_MAX:
                self._owners.clear()
            owner = self._owners[g] = zlib.crc32(repr(g).encode()) % self.n_shards
        return owner

    def _route(self, prep: dict, rows) -> Dict[int, list]:
        """Row positions by owning shard, each list in arrival order."""
        tuples = prep["group_tuples"]
        owner_of = self._owner_of
        owned: Dict[int, list] = {}
        for i in rows:
            owned.setdefault(owner_of(tuples[i]), []).append(i)
        return owned

    # -------------------------------------------------------------- ingest

    def _fold_batch(self, cols) -> None:
        """Route one batch's rows once, then fold each shard's rows in
        arrival order under that shard's lock, recording exactly those
        rows in the shard's WAL inside the same lock: a concurrent rebuild
        then sees the batch either folded and recorded or neither."""
        prep = self._prepare_batch(cols)
        if prep is None:
            return
        t0 = time.perf_counter()
        # ingest re-creates declared granularities a shrinking restore
        # removed (self.store marks the queryable durations; the buckets
        # live in the shards)
        for d in self.durations:
            self.store.setdefault(d, {})
        owned = self._route(prep, prep["idx"].tolist())
        host = prep["cols"]
        for s_idx, rows in owned.items():
            shard = self.shards[s_idx]
            with shard._lock:
                self._fold_rows(shard, prep, rows)
                shard.bump()
                if shard.wal is not None:
                    pos = np.asarray(rows, np.int64)
                    # fancy indexing copies: the record owns its rows
                    shard.wal.record_columns(
                        self.input_stream_id,
                        {k: np.asarray(v)[pos] for k, v in host.items()})
        if self._flush_hist is not None:
            self._flush_hist.record((time.perf_counter() - t0) * 1000.0)

    # --------------------------------------------------------------- query

    def _scatter(self, fn) -> list:
        """Run ``fn(shard)`` over all shards on the shared scatter pool;
        reads inline when the executor refuses new work (interpreter
        teardown)."""
        if self.n_shards == 1:
            return [fn(self.shards[0])]
        from siddhi_tpu_torch.serving.query_tier import scatter_pool

        try:
            futures = [scatter_pool().submit(fn, s) for s in self.shards]
        except RuntimeError:
            return [fn(s) for s in self.shards]
        return [f.result() for f in futures]

    def rows(self, duration: Duration,
             within: Optional[Tuple[int, int]] = None) -> List[list]:
        within = self._resolve_within(duration, within)
        t0 = time.perf_counter()
        parts = self._scatter(lambda s: s.partials(duration))
        t1 = time.perf_counter()
        merged = self._ordered_merge(parts, within)
        t2 = time.perf_counter()
        if self._fanout_hist is not None:
            self._fanout_hist.record((t1 - t0) * 1000.0)
            self._merge_hist.record((t2 - t1) * 1000.0)
        out = self._rows_from_items(merged)
        h = self._query_hists.get(duration)
        if h is not None:
            h.record((time.perf_counter() - t0) * 1000.0)
        return out

    def _ordered_merge(self, parts: List[list],
                       within: Optional[Tuple[int, int]]) -> list:
        """Deterministic k-way merge of per-shard partials, ordered by
        (bucket, group). Ownership is disjoint in steady state; a
        cross-layout restore can surface one (bucket, group) on two
        shards, and duplicates fold by base (``_BaseSpec.fold``)."""
        base_specs = list(self.bases.values())
        merged: list = []
        for item in heapq.merge(*parts, key=_merge_key):
            if within is not None and not (within[0] <= item[0] < within[1]):
                continue
            if merged and _merge_key(merged[-1]) == _merge_key(item):
                prev = merged[-1][2]
                merged[-1] = (item[0], item[1], [
                    spec.fold(a, b)
                    for spec, a, b in zip(base_specs, prev, item[2])])
            else:
                merged.append(item)
        return merged

    def shard_device_contents(self, index: int, duration: Duration):
        """One shard's stitched rollup rows as columnar tensors on the
        shard's device, cached per ingest epoch. Returns
        (output_definition, {col: torch.Tensor}, valid tensor)."""
        import torch

        shard = self.shards[index]
        with shard._lock:
            epoch = shard.epoch
            cached = shard._device_cache.get(duration)
        if cached is not None and cached[0] == epoch:
            return cached[1]
        definition, cols, valid = self._columnize(
            self._rows_from_items(shard.partials(duration)))
        dev = shard.device if shard.device is not None else torch.device("cpu")
        cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in cols.items()}
        valid = torch.from_numpy(valid).to(dev)
        view = (definition, cols, valid)
        with shard._lock:
            if shard.epoch == epoch:
                shard._device_cache[duration] = (epoch, view)
        return view

    def _bucket_count(self, duration: Duration) -> int:
        return sum(len(s.store.get(duration, ())) for s in self.shards)

    # --------------------------------------------------------------- purge

    def purge(self, now: Optional[int] = None) -> int:
        if now is None:
            now = int(self.app_context.timestamp_generator.current_time())
        purged = 0
        for shard in self.shards:
            with shard._lock:
                touched = False
                for d, dstore in shard.store.items():
                    keep_ms = self.retention.get(d)
                    if keep_ms is None:
                        continue
                    cutoff = now - keep_ms
                    drop = [b for b in dstore if b < cutoff]
                    for b in drop:
                        del dstore[b]
                        shard._deleted.add((d, b))
                        shard._dirty.discard((d, b))
                        touched = True
                    purged += len(drop)
                if touched:
                    shard.bump()
        return purged

    # ----------------------------------------------- checkpoint + rebuild

    def _ser_store(self, store) -> dict:
        return {d.value: {b: {g: list(v) for g, v in groups.items()}
                          for b, groups in dstore.items()}
                for d, dstore in store.items()}

    def _deser_store(self, ser) -> dict:
        out = {d: {} for d in self.durations}
        for dv, dstore in ser.items():
            d = parse_duration_name(dv)
            if d not in out:
                continue
            out[d] = {
                int(b): {(tuple(g) if isinstance(g, (list, tuple))
                          else (g,)): list(v)
                         for g, v in groups.items()}
                for b, groups in dstore.items()}
        return out

    def checkpoint_shards(self) -> List[dict]:
        """Per-shard checkpoint blobs ({"store", "cut"}) for the rebuild
        protocol. Each shard's WAL is trimmed at its cut, so the retained
        suffix is exactly what a later ``rebuild_shard`` must replay."""
        blobs = []
        for shard in self.shards:
            with shard._lock:
                cut = shard.wal.cut() if shard.wal is not None else 0
                blobs.append({"shard": shard.index,
                              "store": self._ser_store(shard.store),
                              "cut": cut})
            if shard.wal is not None:
                shard.wal.trim(cut)
        return blobs

    def kill_shard(self, index: int) -> None:
        """Fault injection: wipe one shard's state (its WAL survives, as a
        live process's log would)."""
        self.shards[index].wipe()

    def rebuild_shard(self, index: int, blob: dict) -> int:
        """Restore one lost shard from its last checkpoint blob, then
        re-fold its WAL suffix (records newer than the blob's cut): the
        recorded rows, in their order, exactly as they were folded. A blob
        whose cut predates the WAL's last trim skips the replay: the
        retained suffix follows a newer base. Returns the number of
        replayed records."""
        from siddhi_tpu_torch.resilience import stat_count

        shard = self.shards[index]
        cut = int(blob.get("cut", 0))
        replayed = 0
        with shard._lock:
            shard.store = self._deser_store(blob.get("store", {}))
            shard._dirty = {(d, b) for d, dstore in shard.store.items()
                            for b in dstore}
            shard._deleted.clear()
            shard._partials_cache.clear()
            shard._device_cache.clear()
            if shard.wal is not None:
                if cut < shard.wal.checkpoint_seq:
                    _LOG.warning(
                        "aggregation '%s' shard %d: checkpoint cut %d "
                        "predates the WAL's last trim %d — skipping the "
                        "replay (suffix follows a newer base)",
                        self.definition.id, index, cut,
                        shard.wal.checkpoint_seq)
                    stat_count(self.app_context,
                               "resilience.shard_replay_skips")
                else:
                    recs = shard.wal.records_after(cut)
                    # the bounded log drops its oldest records on
                    # overflow: a hole in the contiguous sequence numbers
                    # past the cut means the rebuild is incomplete
                    newest = shard.wal.cut()
                    first = recs[0].seq if recs else newest + 1
                    if newest > cut and first > cut + 1:
                        _LOG.error(
                            "aggregation '%s' shard %d: WAL overflow "
                            "dropped records %d..%d of the replay suffix "
                            "(bound too small / checkpoints too sparse) — "
                            "rebuilt state is missing those batches",
                            self.definition.id, index, cut + 1, first - 1)
                        stat_count(self.app_context,
                                   "resilience.shard_replay_gaps")
                        tel = getattr(self.app_context, "telemetry", None)
                        if tel is not None:
                            tel.count("serving.shard_replay_gaps")
                    for rec in recs:
                        prep = self._prepare_batch(rec.payload)
                        if prep is None:
                            continue
                        rows = [i for i in prep["idx"].tolist()
                                if self._owner_of(prep["group_tuples"][i]) == index]
                        self._fold_rows(shard, prep, rows)
                        replayed += 1
            shard.bump()
        stat_count(self.app_context, "resilience.shard_rebuilds")
        tel = getattr(self.app_context, "telemetry", None)
        if tel is not None:
            tel.count("serving.shard_rebuilds")
        return replayed

    # ---------------------------------------------------------- snapshots

    def snapshot(self) -> dict:
        shards = []
        self._last_cuts = []
        for shard in self.shards:
            with shard._lock:
                shards.append({"shard": shard.index,
                               "store": self._ser_store(shard.store)})
                self._last_cuts.append(
                    shard.wal.cut() if shard.wal is not None else 0)
        return {"sharded": True, "n_shards": self.n_shards,
                "base_keys": list(self.bases), "shards": shards}

    def restore(self, snap: dict):
        # merge to one flat store, realign base keys through the base
        # class's restore, then re-route every (bucket, group) to its
        # owner: an unsharded revision or another shard count restores
        # the same way
        if snap.get("sharded"):
            snap = self._merge_sharded_snapshot(snap)
        holder = _RestoreTarget(self)
        IncrementalAggregationRuntime.restore(holder, snap)
        # the queryable granularity set follows the restored state (fewer
        # or more durations than declared both work: _resolve_within
        # checks the store, and ingest re-creates declared durations)
        for shard in self.shards:
            with shard._lock:
                shard.store = {d: {} for d in holder.store}
                shard._dirty.clear()
                shard._deleted.clear()
                shard._partials_cache.clear()
                shard._device_cache.clear()
        for d, dstore in holder.store.items():
            for b, groups in dstore.items():
                for g, vals in groups.items():
                    shard = self.shards[self._owner_of(g)]
                    shard.store[d].setdefault(b, {})[g] = vals
        self.store = {d: {} for d in holder.store}
        for shard in self.shards:
            with shard._lock:
                shard.bump()
                # the restored state supersedes any retained suffix
                if shard.wal is not None:
                    shard.wal.mark_checkpoint()

    # --------------------------------------------- incremental snapshots

    def incremental_snapshot(self) -> dict:
        shards = []
        for shard in self.shards:
            with shard._lock:
                out = {"buckets": {}, "deleted": []}
                for d, b in shard._dirty:
                    groups = shard.store.get(d, {}).get(b)
                    if groups is None:
                        continue
                    out["buckets"].setdefault(d.value, {})[b] = {
                        g: list(v) for g, v in groups.items()}
                out["deleted"] = [(d.value, b) for d, b in shard._deleted]
                shards.append(out)
        return {"sharded": True, "shards": shards}

    def clear_oplog(self):
        for i, shard in enumerate(self.shards):
            with shard._lock:
                shard._dirty.clear()
                shard._deleted.clear()
            if shard.wal is not None and i < len(self._last_cuts):
                # the revision covering _last_cuts is now durable: the
                # retained suffix follows it
                shard.wal.trim(self._last_cuts[i])

    def apply_increment(self, snap: dict):
        if snap.get("sharded") and len(snap.get("shards", [])) == self.n_shards:
            for shard, sub in zip(self.shards, snap["shards"]):
                with shard._lock:
                    for dv, b in sub.get("deleted", []):
                        shard.store.get(Duration(dv), {}).pop(b, None)
                    for dv, buckets in sub.get("buckets", {}).items():
                        d = Duration(dv)
                        dstore = shard.store.setdefault(d, {})
                        for b, groups in buckets.items():
                            dstore[b] = {g: list(v) for g, v in groups.items()}
                    shard.bump()
            return
        # a foreign layout (unsharded, or another shard count): buckets
        # are replaced whole, split by ownership
        subs = snap.get("shards", [snap]) if snap.get("sharded") else [snap]
        for sub in subs:
            for dv, b in sub.get("deleted", []):
                d = Duration(dv)
                for shard in self.shards:
                    with shard._lock:
                        if shard.store.get(d, {}).pop(b, None) is not None:
                            shard.bump()
            for dv, buckets in sub.get("buckets", {}).items():
                d = Duration(dv)
                for b, groups in buckets.items():
                    owned: Dict[int, dict] = {}
                    for g, v in groups.items():
                        g = tuple(g) if isinstance(g, (list, tuple)) else (g,)
                        owned.setdefault(self._owner_of(g), {})[g] = list(v)
                    for shard in self.shards:
                        mine = owned.get(shard.index)
                        with shard._lock:
                            dstore = shard.store.setdefault(d, {})
                            if mine:
                                dstore[b] = mine
                            else:
                                dstore.pop(b, None)
                            shard.bump()

    # ------------------------------------------------- DB shard-stitch API

    def publish_shard(self):  # pragma: no cover — guarded at construction
        raise RuntimeError(
            "in-process mesh sharding replaces @PartitionById DB-stitch "
            "publishing (MIGRATION.md)")

    def stitch_shards(self) -> int:  # pragma: no cover
        raise RuntimeError(
            "in-process mesh sharding replaces @PartitionById DB-stitch "
            "reads (MIGRATION.md)")


class _RestoreTarget:
    """A bare store holder the base class's ``restore`` writes into: the
    sharded runtime's base keys and a lock of its own."""

    def __init__(self, runtime: ShardedIncrementalAggregation):
        self.bases = runtime.bases
        self.store: dict = {}
        self._lock = make_lock("shard")
