"""Declared lock partial order: the one source of truth for lock ranks.

Counterpart of ``siddhi_tpu/analysis/lockorder.py``, a copy: the same
ranks, the same edges, the same closure. The hot-path locking discipline
(the "owner -> pump" contract in ``core/query/completion.py``, "fold
under the shard lock, WAL record inside it", the app ingestion barrier
that everything else nests under) is data here, read by the runtime shim
``analysis/locks.py``: under ``SIDDHI_TPU_SANITIZE=1`` it asserts the
order on every acquisition; the static rules R4 and R8
(``analysis/rules_locks.py``, ``rules_guards.py``) read the same table
and the recognizers below.

``EDGES`` are "must be acquired before" pairs: ``("owner", "pump")``
means a thread holding a *pump*-ranked lock may never acquire an
*owner*-ranked lock. Same-rank nesting is always allowed (chained
queries take owner locks down the emit cascade; re-entrant RLocks are
re-entrant by design).

Ranked locks are created through ``analysis.locks.make_lock(rank)``;
locks created bare (telemetry registries, scheduler, tables, ...) have
no rank and are transparent to the checker. Every rank a ``make_lock``
site of the port names is declared here.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

# rank -> owning subsystem, for error messages and docs
RANKS: Dict[str, str] = {
    "barrier": "app ingestion barrier (SiddhiAppRuntime._barrier)",
    "owner": "per-query / fused-group lock (QueryRuntime._lock, "
             "FusedFanoutRuntime._lock)",
    "pump": "CompletionPump._lock (core/query/completion.py)",
    "shard": "AggregationShard._lock (serving/sharded_aggregation.py)",
    "wal": "IngestWAL._lock (resilience/replay.py)",
    "ingest": "IngestPackPool._lock (core/stream/input/pack_pool.py)",
    "autopilot": "AutopilotController locks (siddhi_tpu_torch/autopilot/"
                 "controller.py)",
    "adapt": "StreamJunction._adapt_lock (core/stream/junction.py)",
    "overload": "OverloadManager / FairScheduler / AppOverloadControl "
                "locks (resilience/overload.py)",
    "app_supervisor": "AppSupervisor._lock (resilience/supervisor.py)",
    # cluster fabric (siddhi_tpu_torch/cluster/)
    "cluster_ingest": "ClusterRuntime._ingest_lock — global sequencing "
                      "+ checkpoint barrier (cluster/router.py)",
    "link": "_WorkerLink._lock — send vs recovery session "
            "(cluster/router.py)",
    "router": "ClusterRuntime._lock — link attach/invalidate, ids "
              "(cluster/router.py)",
    "egress": "OrderedEgress._lock/_cv (cluster/egress.py)",
    "cluster_supervisor": "WorkerSupervisor._lock "
                          "(cluster/supervisor.py)",
}

# (first, second): `first` must be acquired before `second`; acquiring
# `first` while holding `second` is an inversion.
EDGES: Tuple[Tuple[str, str], ...] = (
    ("barrier", "owner"),   # send/persist hold the barrier around dispatch
    ("owner", "pump"),      # the pump lock never wraps an owner
    ("barrier", "shard"),   # checkpoint_shards runs under the app barrier
    ("shard", "wal"),       # fold + WAL record are atomic vs rebuild
    ("barrier", "wal"),     # ingest records the WAL under the barrier
    # parallel pack runs inside delivery (barrier and owner may be held);
    # the pool's bookkeeping lock is a leaf — pool workers take NO ranked
    # locks, so nothing is ever acquired under "ingest"
    ("barrier", "ingest"),
    ("owner", "ingest"),
    # the autopilot tick is outermost: actuators take owner locks (join
    # Wp rebuild, reshard), drain the pump (flush_owner) and resize the
    # ingest pool while a controller tick is in progress — nothing in
    # the engine ever calls back INTO the controller under its locks
    ("autopilot", "barrier"),
    ("autopilot", "owner"),
    ("autopilot", "pump"),
    ("autopilot", "ingest"),
    # cluster fabric (cluster/router.py): the global-sequencing lock is
    # outermost — _ingest_frame splits + sends runs (link session) and
    # registers egress expectations under it; the checkpoint barrier
    # cuts/trims worker WALs under it
    ("cluster_ingest", "link"),
    ("cluster_ingest", "egress"),
    ("cluster_ingest", "wal"),
    # a send/recovery failure invalidates the session and notifies the
    # supervisor while holding the link session lock
    ("link", "router"),
    ("link", "egress"),      # recovery replays forget/drop under session
    ("link", "wal"),         # recovery reads the WAL suffix under session
    # the reader thread notifies the supervisor under the router lock;
    # the supervisor lock is a leaf (it never calls back into the router
    # under its own lock)
    ("router", "cluster_supervisor"),
)

# Static-rule recognizers (R4, R8): `NAME._lock` / `NAME` in a `with`
# resolves to a rank when the variable name is one of these (the runtime
# shim needs no heuristics — the lock object carries its rank). The
# port's sites: `owner._lock` (core/query/completion.py, the pump's
# flush), `q._lock` (a QueryRuntime's owner lock: core/app_runtime.py,
# core/util/snapshot.py), `shard._lock` (serving/sharded_aggregation.py),
# `link._lock` (cluster/router.py); the others name the reference's.
VARIABLE_RANKS: Dict[str, str] = {
    "owner": "owner",
    "q": "owner",
    "pump": "pump",
    "barrier": "barrier",
    "shard": "shard",
    "wal": "wal",
    "pool": "ingest",
    "link": "link",          # _WorkerLink._lock (cluster/router.py)
    "egress": "egress",      # OrderedEgress._lock (cluster/egress.py)
}

# Attribute names that denote the app barrier regardless of receiver
# (`self._barrier`, `rt._barrier`, `app_runtime._barrier`).
BARRIER_ATTRS = ("_barrier",)


def must_precede() -> FrozenSet[Tuple[str, str]]:
    """Transitive closure of ``EDGES`` as a frozen set of
    (first, second) pairs."""
    closure = set(EDGES)
    changed = True
    while changed:
        changed = False
        for a, b in list(closure):
            for c, d in list(closure):
                if b == c and (a, d) not in closure:
                    closure.add((a, d))
                    changed = True
    return frozenset(closure)


_CLOSURE = must_precede()


def inversion(held_rank: str, acquiring_rank: str) -> bool:
    """True when acquiring ``acquiring_rank`` while holding
    ``held_rank`` inverts the declared order."""
    if held_rank == acquiring_rank:
        return False
    return (acquiring_rank, held_rank) in _CLOSURE
