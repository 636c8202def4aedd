"""SnapshotService: checkpoint and restore of a whole app's state.

Counterpart of ``siddhi_tpu/core/util/snapshot.py`` (reference
``util/snapshot/SnapshotService.java`` and the
``persist``/``restoreRevision``/``restoreLastRevision`` lifecycle of
``SiddhiAppRuntimeImpl.java:677-755``). A snapshot is a versioned pickle
of the reference's format (``FORMAT_VERSION`` 4, the same top-level and
per-query keys): each query's state tree as numpy at the reference's
dtypes and capacities (a routed query's canonical unsharded tree at
global capacities, a join's without the engine's derived directories),
the host-side key dictionaries (strings, group keyers, partition key
spaces with their free lists), host windows, named windows, tables,
aggregation bucket stores, a pattern's per-key high-water marks and the
event clock. A revision persisted by either package restores into the
other. The app barrier quiesces input during both operations.

Two rules keep revisions portable and loading them safe:

- a snapshot pickles builtins and numpy only, never a tensor or a class
  of either package; ``safe_loads`` unpickles with a restricted
  ``Unpickler`` that refuses any other global by name, before importing
  it (loading a reference revision never imports ``siddhi_tpu``);
- a restored leaf must have the dtype the runtime's own state has at that
  place: a mismatch raises naming the leaf instead of being cast.

``_to_host`` makes one device-to-host copy per leaf; ``_to_device`` puts
numpy onto the runtime's device (never torch's default). Each service
counts the bytes it moved (``d2h_bytes``, ``h2d_bytes``).

With an ingest WAL attached (``SiddhiAppRuntime.enable_wal``), ``persist``
drains the @Async queues and cuts the WAL inside the barrier, and trims it
once the revision is saved; ``restore_revision`` replays the retained
suffix unless the restored revision precedes the WAL's checkpoint (the
stale-revision rule). Under ``@app:statistics`` a persist's latency lands
in the ``snapshot.persist`` tracker.

A restore writes each query's group-key map into the query's own keyer
(a fused fan-out member may share a sibling's), then every fused group
re-derives its sharing and drops its step and captured graphs
(``FusedFanoutRuntime.on_restore``): the restored tensors are new, and a
graph binds addresses. Each query's step is dropped too and rebuilt at
its next batch. A step that shares a program-cache entry
(``core/util/program_cache.py``) attaches to it again and captures
nothing: the entry's graph runs over its own slot, into which the
restored state is copied at each replay. A private graph (the cache off,
or an entry with no other sharer) is captured anew.

Left out, each waiting for its subsystem: the multi-process allgather of
``_to_host`` (ROADMAP A.9); the ``persist`` span (A.10).
"""

from __future__ import annotations

import io
import itertools
import logging
import pickle
import time
from typing import List, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

# v4: the reference's current format (GroupKeyer key tuples with null-mask
# elements, shifted single-string LUT ids, aggregation base_keys)
FORMAT_VERSION = 4

# the builtins a snapshot may name: containers and scalar types
_SAFE_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "range", "set", "slice", "str", "tuple"})
# numpy's array, dtype and scalar reconstructors, under numpy 1 and 2 names
_SAFE_NUMPY = {
    "numpy": frozenset({"dtype", "ndarray"}),
    "numpy.core.multiarray": frozenset({"_reconstruct", "scalar"}),
    "numpy._core.multiarray": frozenset({"_reconstruct", "scalar"}),
    "numpy.core.numeric": frozenset({"_frombuffer"}),
    "numpy._core.numeric": frozenset({"_frombuffer"}),
}


def safe_global(module: str, name: str) -> bool:
    """Whether a snapshot may name ``module.name``: a builtin container or
    scalar type, or one of numpy's array, dtype and scalar builders."""
    if module == "builtins":
        return name in _SAFE_BUILTINS
    if module == "numpy.dtypes":
        return name.endswith("DType")
    return name in _SAFE_NUMPY.get(module, ())


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if not safe_global(module, name):
            # refused before any import: a global of another package is
            # never loaded, let alone run
            raise pickle.UnpicklingError(
                f"snapshot names '{module}.{name}': a snapshot holds builtins "
                f"and numpy only, so this global is refused")
        return super().find_class(module, name)


def safe_loads(data: bytes):
    """Unpickle a snapshot (or a shard blob) allowing only ``safe_global``
    names."""
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


class SnapshotService:
    def __init__(self, app_runtime):
        self.app_runtime = app_runtime
        self.d2h_bytes = 0
        self.h2d_bytes = 0

    # ---------------------------------------------------- device transfer

    def _to_host(self, tree):
        """Tensors -> numpy, one device-to-host copy per leaf (numpy and
        Python leaves pass through)."""
        def pull(_path, x):
            if isinstance(x, torch.Tensor):
                a = x.detach().cpu().numpy()
                if x.device.type == "cpu":
                    a = a.copy()     # the state is updated in place later
                self.d2h_bytes += a.nbytes
                return a
            return x

        return _map(pull, tree)

    def _to_device(self, tree, device, like, what: str):
        """numpy -> tensors on ``device``, once ``check_state`` holds the
        tree to ``like`` (the runtime's own state)."""
        check_state(tree, like, what)
        return self._push(tree, device)

    def _push(self, tree, device):
        def push(_path, x):
            a = np.asarray(x)
            if (not a.flags.writeable or not a.flags.c_contiguous
                    or device.type == "cpu"):
                a = a.copy(order="C")    # 0-d stays 0-d
            self.h2d_bytes += a.nbytes
            return torch.from_numpy(a).to(device)

        return _map(push, tree)

    # ------------------------------------------------------------ capture

    def _capture_common(self) -> dict:
        rt = self.app_runtime
        dictionary = rt.app_context.string_dictionary
        pump = rt.app_context.completion_pump
        if pump.has_pending:
            # batches riding the dispatch pipeline drain inside the
            # barrier: their state updates are already in the trees read
            # below, so their outputs emit before the cut
            pump.flush()
        queries = {}
        for name, q in rt.query_runtimes.items():
            with q._lock:
                rl = getattr(q, "_route_layout", None)
                # a join's engine directories are derived: dropped before
                # the copy, the capture keeps the [W] rings only
                strip = getattr(q, "strip_engine_state", None) or (lambda st: st)
                if rl is not None and q._state is not None:
                    # a routed runtime snapshots canonical (unsharded) state
                    # at global capacities, so revisions cross-restore
                    # between shard counts and the unrouted runtime
                    from siddhi_tpu_torch.parallel.mesh import canonical_route_state

                    state = strip(canonical_route_state(q))
                    self.d2h_bytes += _tree_nbytes(state)
                    sel_keys = rl.n * rl.localK
                    win_keys = rl.n * rl.local_win if rl.local_win > 1 else q._win_keys
                else:
                    state = (self._to_host(strip(q._state)) if q._state is not None
                             else None)
                    sel_keys = q.selector_plan.num_keys
                    win_keys = q._win_keys
                hwm = getattr(q, "_nfa_hwm_arr", None)
                queries[name] = {
                    "state": state,
                    "sel_keys": sel_keys,
                    "win_keys": win_keys,
                    "keyer_map": dict(q.keyer._map) if q.keyer is not None else None,
                    "host_window": (q.host_window.snapshot()
                                    if q.host_window is not None else None),
                    "nfa_hwm": np.array(hwm) if hwm is not None else None,
                }
        windows = {}
        for wid, w in rt.named_windows.items():
            with w._lock:
                if w.host_mode:
                    windows[wid] = {"host": True, "data": w.stage.snapshot()}
                else:
                    windows[wid] = {"host": False, "data": self._to_host(w.state)}
        return {
            "version": FORMAT_VERSION,
            "app": rt.name,
            "strings": list(dictionary._to_str),
            "queries": queries,
            "windows": windows,
            "partitions": [p.keyspace.snapshot() for p in rt.partition_contexts],
            # the playback clock: a restore mid-trace resumes event time
            "clock": rt.app_context.timestamp_generator._last_event_ts,
        }

    def full_snapshot(self) -> bytes:
        """Pure capture: op logs are cleared by ``mark_checkpoint`` only
        once the revision is saved."""
        rt = self.app_runtime
        obj = self._capture_common()
        tables = {}
        for tid, t in rt.tables.items():
            if not hasattr(t, "state"):
                continue    # a @store record table owns its durability
            with t._lock:
                tables[tid] = {"state": self._to_host(t.state), "capacity": t.capacity}
        obj["tables"] = tables
        obj["aggregations"] = {aid: a.snapshot() for aid, a in rt.aggregations.items()}
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)

    def mark_checkpoint(self):
        """Clear the op logs once a checkpoint is stored (clearing before
        the save would lose deltas on a failed save)."""
        rt = self.app_runtime
        for t in rt.tables.values():
            if hasattr(t, "clear_oplog"):
                t.clear_oplog()
        for a in rt.aggregations.values():
            a.clear_oplog()

    def incremental_snapshot(self, base_revision: str) -> bytes:
        """Op-log deltas for the history holders (aggregation buckets,
        table inserts) and full state for the rest (reference
        ``SnapshotService.java:189`` IncrementalSnapshotable)."""
        rt = self.app_runtime
        obj = self._capture_common()
        obj["incremental"] = True
        obj["base"] = base_revision
        obj["tables_inc"] = {
            tid: t.incremental_snapshot()
            for tid, t in rt.tables.items() if hasattr(t, "incremental_snapshot")}
        obj["aggregations_inc"] = {
            aid: a.incremental_snapshot() for aid, a in rt.aggregations.items()}
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)

    # ------------------------------------------------------------ restore

    def restore(self, data: bytes):
        obj = safe_loads(data)
        if obj.get("incremental"):
            raise ValueError(
                "incremental snapshot cannot be restored standalone — "
                "restore its base chain via PersistenceManager")
        self._restore_obj(obj)
        self.mark_checkpoint()   # restored state must not re-enter op logs

    def apply_incremental(self, data, rearm: bool = True):
        """One incremental checkpoint on top of restored state: the light
        components overwrite, the history holders apply their op logs."""
        obj = safe_loads(data) if isinstance(data, (bytes, bytearray)) else data
        self._restore_obj(obj, incremental=True)
        rt = self.app_runtime
        for tid, snap in obj.get("tables_inc", {}).items():
            t = rt.tables.get(tid)
            if t is not None and hasattr(t, "apply_increment"):
                t.apply_increment(snap)
        for aid, snap in obj.get("aggregations_inc", {}).items():
            a = rt.aggregations.get(aid)
            if a is not None:
                a.apply_increment(snap)
        if rearm:
            self._rearm_schedulers()

    def _restore_obj(self, obj, incremental: bool = False):
        if obj.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"snapshot format {obj.get('version')} is not supported "
                f"(expected {FORMAT_VERSION})")
        rt = self.app_runtime
        if obj.get("app") != rt.name:
            raise ValueError(
                f"snapshot belongs to app '{obj.get('app')}', not '{rt.name}' — "
                f"name apps with @app:name for stable restore identities")
        for name in obj["queries"]:
            if name not in rt.query_runtimes:
                raise ValueError(f"snapshot has unknown query '{name}'")
        dictionary = rt.app_context.string_dictionary
        # the fresh runtime's compile-time strings are a prefix of the
        # snapshot's (the same app text parses in the same order)
        strings = obj["strings"]
        if strings[: len(dictionary._to_str)] != dictionary._to_str[:len(strings)]:
            raise ValueError(
                "snapshot belongs to a different app (string dictionaries diverge)")
        dictionary.restore_strings(strings)

        # the event clock, forced: restoring an earlier revision in place
        # rolls the clock back with the state
        clock = obj.get("clock", -1)
        if clock is not None and clock >= 0:
            rt.app_context.timestamp_generator.reset_timestamp(int(clock))

        for snap, pctx in zip(obj["partitions"], rt.partition_contexts):
            pctx.keyspace.restore(snap)

        # in-flight pipelined outputs belong to the rolled-back timeline
        rt.app_context.completion_pump.discard_all()

        dev = rt.app_context.device
        for name, qsnap in obj["queries"].items():
            self._restore_query(rt.query_runtimes[name], qsnap, dev)
        # fused fan-out groups: sharing re-derived from the restored maps,
        # the step and its graphs dropped (new tensors, maybe new capacities)
        for g in getattr(rt, "fused_fanout_groups", ()):
            g.on_restore()

        for tid, tsnap in obj.get("tables", {}).items():
            t = rt.tables.get(tid)
            if t is None:
                raise ValueError(f"snapshot has unknown table '{tid}'")
            install_table_state(t, tsnap["state"], tsnap["capacity"], self)

        for aid, asnap in obj.get("aggregations", {}).items():
            a = rt.aggregations.get(aid)
            if a is None:
                raise ValueError(f"snapshot has unknown aggregation '{aid}'")
            a.restore(asnap)

        for wid, wsnap in obj["windows"].items():
            w = rt.named_windows.get(wid)
            if w is None:
                raise ValueError(f"snapshot has unknown window '{wid}'")
            with w._lock:
                if wsnap.get("host"):
                    w.stage.restore(wsnap["data"])
                else:
                    w.state = self._to_device(wsnap["data"], dev, like=w.state,
                                              what=f"window {wid}")

        if not incremental:
            self._rearm_schedulers()

    def _restore_query(self, q, qsnap: dict, dev) -> None:
        with q._lock:
            if q.rate_limiter is not None and hasattr(q.rate_limiter, "reset"):
                # buffered limiter state would flush phantom pre-restore
                # events after the rollback
                q.rate_limiter.reset()
            if q.keyer is not None and qsnap["keyer_map"] is not None:
                # into the query's OWN keyer: a fused fan-out member may
                # share a sibling's, and the revision may hold divergent
                # maps (the group re-derives sharing: on_restore)
                keyer = getattr(q, "_own_keyer", None)
                if keyer is None:   # explicit: an empty keyer is falsy
                    keyer = q.keyer
                keyer._map = dict(qsnap["keyer_map"])
                keyer._next = max(keyer._map.values(), default=-1) + 1
                keyer._lut = np.full(64, -1, np.int32)   # rebuilt lazily
                q.keyer = keyer
            state = qsnap["state"]
            layout = getattr(q, "_route_layout", None)
            # the runtime's own state gives the keys and dtypes to hold to
            like = q._state if q._state is not None else q._init_state()
            strip = getattr(q, "strip_engine_state", None)
            if strip is not None:
                like = strip(like)
            what = f"query {q.name}"
            for i, spec in enumerate(q.selector_plan.specs):
                st = ((state or {}).get("sel") or {}).get(f"a{i}")
                if isinstance(st, dict):      # a value table keeps its width H
                    spec.distinct_capacity = int(np.asarray(st["vk"]).shape[1])
            if layout is not None:
                # canonical tree -> this runtime's shard-major layout (the
                # snapshot may come from another shard count, or unrouted)
                from siddhi_tpu_torch.parallel.mesh import _install_routed

                if state is not None:
                    check_state(state, like, what)
                    self.h2d_bytes += _tree_nbytes(state)
                _install_routed(q, layout, state, qsnap["sel_keys"], qsnap["win_keys"])
            else:
                q.selector_plan.num_keys = qsnap["sel_keys"]
                q._win_keys = qsnap["win_keys"]
                q._state = None     # release the old state before the upload
                q._state = (self._to_device(state, dev, like, what)
                            if state is not None else None)
            if q.host_window is not None and qsnap.get("host_window") is not None:
                q.host_window.restore(qsnap["host_window"])
            if hasattr(q, "_nfa_hwm_arr"):
                # no marks in the snapshot: the mirror resets, or post-
                # snapshot marks would route every later batch to the
                # generic step and feed expire_to from the abandoned timeline
                hwm = qsnap.get("nfa_hwm")
                q._nfa_hwm_arr = np.array(hwm, np.int64) if hwm is not None else None
            if layout is None:
                q._step = None
            if hasattr(q, "_steps"):
                q._steps.clear()
            adopt = getattr(q, "adopt_restored_state", None)
            if adopt is not None:
                adopt()    # a join: the engine's directories from the rings

    def _rearm_schedulers(self):
        """Re-arm the expiry timers of restored time-driven stages: one
        immediate TIMER step per stage drains what is already due and asks
        for the next wake time. A runtime that is shutting down arms
        nothing."""
        rt = self.app_runtime
        scheduler = rt.app_context.scheduler
        if scheduler is None or rt.app_context.stopped:
            return
        # timers of the pre-restore timeline are void
        scheduler.clear_pending()
        now = int(rt.app_context.timestamp_generator.current_time())
        for q in rt.query_runtimes.values():
            if getattr(q, "_state", None) is None:
                continue
            sides = getattr(q, "sides", None)
            if sides is not None:     # a join: one timer target a side
                for sk, side in sides.items():
                    if (side.window_stage is not None
                            and getattr(side.window_stage, "needs_scheduler", False)):
                        scheduler.notify_at(now, q._timer_cbs[sk])
                continue
            win = getattr(q, "window_stage", None)
            host = getattr(q, "host_window", None)
            needs = ((win is not None and getattr(win, "needs_scheduler", False))
                     or (host is not None and getattr(host, "needs_scheduler", False)))
            if needs:
                scheduler.notify_at(now, q.process_timer)
        for w in rt.named_windows.values():
            if getattr(w.stage, "needs_scheduler", False):
                scheduler.notify_at(now, w.process_timer)


def install_table_state(table, state: dict, capacity: int, service=None) -> None:
    """A table's ``{"cols", "valid"}`` numpy state onto its device. The
    columns must be the table's; their dtypes install as the revision
    holds them, since an update may have promoted a column (as the
    reference's ``jnp.where`` does)."""
    svc = service or SnapshotService(None)
    what = f"table {table.definition.id}"
    with table._lock:
        if set(state["cols"]) != set(table.state["cols"]):
            raise ValueError(f"snapshot {what} holds columns {sorted(state['cols'])}, "
                             f"the table {sorted(table.state['cols'])}")
        check_state(state["valid"], table.state["valid"], what, ("valid",))
        table.state = svc._push(state, table.device)
        table.capacity = int(capacity)
        table._pk_dirty = True
        table._idx_dirty = True


def _np_dtype(t) -> np.dtype:
    if isinstance(t, torch.Tensor):
        return torch.empty(0, dtype=t.dtype).numpy().dtype
    return np.asarray(t).dtype


def check_state(tree, like, what: str, path=()) -> None:
    """A snapshot's tree holds the runtime's keys, level by level, and
    each leaf the dtype the runtime's leaf has (capacities may differ):
    anything else raises, naming the place."""
    where = f"snapshot {what}/{'/'.join(map(str, path))}"
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(map(str, tree)) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{where} holds {got}, the runtime's state "
                             f"{sorted(map(str, like))}")
        for k in like:
            check_state(tree[k], like[k], what, path + (k,))
        return
    got, want = np.asarray(tree).dtype, _np_dtype(like)
    if got != want:
        raise ValueError(f"{where} is {got}, the runtime's state holds {want} "
                         f"there: refused, not cast")


def _tree_nbytes(tree) -> int:
    total = 0

    def add(_p, x):
        nonlocal total
        total += int(np.asarray(x).nbytes)
        return x

    if tree is not None:
        _map(add, tree)
    return total


class PersistenceManager:
    """The persist and restore lifecycle against the configured store
    (reference ``SiddhiAppRuntimeImpl.persist:677``,
    ``restoreRevision:719``)."""

    def __init__(self, app_runtime):
        self.app_runtime = app_runtime
        self.snapshot_service = SnapshotService(app_runtime)
        self._last_revision: Optional[str] = None
        # persistence is in use: tables journal their inserts so that
        # incremental checkpoints have an op log to draw from
        for t in app_runtime.tables.values():
            if hasattr(t, "journal_enabled"):
                t.journal_enabled = True

    def _store(self):
        store = self.app_runtime.app_context.siddhi_context.persistence_store
        if store is None:
            raise RuntimeError(
                "no persistence store configured — call "
                "SiddhiManager.set_persistence_store(...) first")
        return store

    _seq = itertools.count()  # ms collisions must not overwrite revisions

    def _drain_async_junctions(self, timeout_s: float = 5.0) -> bool:
        """Wait, holding the barrier, until every @Async junction's queue
        and in-flight unit are applied: the barrier stops new sends, the
        workers keep draining. False if a wedged worker did not drain in
        time."""
        from siddhi_tpu_torch.core.stream.junction import _NOTHING

        rt = self.app_runtime
        deadline = time.monotonic() + timeout_s
        while True:
            busy = [j for j in rt.junctions.values()
                    if getattr(j, "_async", False) and j._running
                    and (not j._queue.empty() or j._inflight is not _NOTHING)]
            if not busy:
                return True
            if time.monotonic() > deadline:
                log.warning(
                    "persist: async junction(s) %s did not drain in %.1fs",
                    [j.definition.id for j in busy], timeout_s)
                return False
            time.sleep(0.001)

    def persist(self, incremental: bool = False) -> str:
        """A full checkpoint, or (``incremental=True``, after a full one)
        an op-log delta chained to the previous revision."""
        t_start = time.perf_counter()
        rt = self.app_runtime
        store = self._store()
        wal = rt.app_context.ingest_wal
        with rt._barrier:   # quiesce inputs (ThreadBarrier)
            # accepted-but-queued @Async batches are applied before the
            # capture, or the WAL cut below would cover them unapplied
            drained = self._drain_async_junctions()
            if incremental and self._last_revision is not None:
                data = self.snapshot_service.incremental_snapshot(self._last_revision)
            else:
                data = self.snapshot_service.full_snapshot()
            # the cut marks what this snapshot covers; the trim waits for
            # the save, so a batch accepted after the barrier releases
            # survives in the log
            wal_cut = wal.cut() if (wal is not None and drained) else None
        # sortable: ms prefix, then a process-monotonic counter
        revision = (f"{int(time.time() * 1000):020d}_"
                    f"{next(self._seq):06d}_{rt.name}")
        store.save(rt.name, revision, data)
        # only once the save is done: clear the op logs, trim the WAL
        self.snapshot_service.mark_checkpoint()
        if wal_cut is not None:
            wal.trim(wal_cut)
            wal.checkpoint_revision = revision
        self._last_revision = revision
        sm = rt.app_context.statistics_manager
        if sm is not None and sm.level >= 1:
            # a checkpoint stalls ingest for its whole capture: its tail
            # belongs beside the queries'
            sm.latency_tracker("snapshot.persist").record(
                (time.perf_counter() - t_start) * 1000.0)
        return revision

    def persist_incremental(self) -> str:
        return self.persist(incremental=True)

    def restore_revision(self, revision: str):
        rt = self.app_runtime
        store = self._store()
        # the base chain: a stack of increments over one full snapshot
        chain: List[dict] = []
        rev: Optional[str] = revision
        while rev is not None:
            data = store.load(rt.name, rev)
            if data is None:
                raise KeyError(f"revision '{rev}' not found for app '{rt.name}'")
            obj = safe_loads(data)
            chain.append(obj)
            rev = obj.get("base") if obj.get("incremental") else None
        with rt._barrier:
            svc = self.snapshot_service
            svc._restore_obj(chain[-1])
            for obj in reversed(chain[:-1]):
                svc.apply_incremental(obj, rearm=False)
            svc._rearm_schedulers()
            # replayed state must not re-enter the next delta's op log
            svc.mark_checkpoint()
        self._last_revision = revision
        # effectively-once: re-feed the post-checkpoint ingest suffix in
        # arrival order, outside the barrier (replay sends re-enter it).
        # The suffix follows wal.checkpoint_revision: grafted onto an older
        # revision it would miss the middle, so that case skips the replay
        # and keeps the log. Revisions sort by their ms prefix
        wal = rt.app_context.ingest_wal
        if wal is not None and len(wal):
            if (wal.checkpoint_revision is None
                    or revision >= wal.checkpoint_revision):
                wal.replay(rt)
            else:
                log.warning(
                    "ingest-WAL replay skipped: restored revision %s "
                    "precedes the WAL's checkpoint %s — the retained "
                    "suffix does not follow this base",
                    revision, wal.checkpoint_revision)

    def restore_last_revision(self) -> Optional[str]:
        rt = self.app_runtime
        rev = self._store().get_last_revision(rt.name)
        if rev is not None:
            self.restore_revision(rev)
        return rev

    def clear_all_revisions(self):
        self._store().clear_all_revisions(self.app_runtime.name)
        # the next incremental must not chain to a wiped revision
        self._last_revision = None
