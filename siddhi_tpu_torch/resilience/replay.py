"""Ingest WAL: a bounded, per-process replay log for effectively-once
recovery.

Counterpart of ``siddhi_tpu/resilience/replay.py``. Full snapshots are
already O(state) for dense-array runtimes (SURVEY.md §5.4), so the only thing a checkpoint loses is the ingest SUFFIX — every
batch accepted after the last barrier. The WAL records that suffix at the
``InputHandler``/``StreamJunction`` boundary (inside the snapshot quiesce
barrier, so a checkpoint always cuts at a batch boundary), is trimmed at
every durable checkpoint, and is replayed in arrival order after
``restore_revision``. Region-based-state streaming (PAPERS.md) makes this
the cheap half of recovery: state restore is one copy of the state
tensors, replay is a re-send of host-side columnar batches. A record owns
its copy of every column (``_copy_columns``): producers reuse their
buffers (a wire frame's payload, a caller's staging array), and a record
that viewed one would replay the next batch's data.

Bounds and overflow: the log is bounded by ``max_batches`` (and optionally
``max_events``). On overflow the OLDEST record is dropped and
``dropped_batches`` is bumped — recovery from the previous checkpoint then
has a hole, which the counter (and the ``resilience.wal_dropped_batches``
statistic) makes visible. Operators should checkpoint at least as often
as the WAL can hold; the bound trades recovery completeness for a hard
memory ceiling, never blocking ingest.

Trim protocol: appends and checkpoint cuts both happen under the app's
ingestion barrier, but the durable save happens OUTSIDE it (persist()
releases the barrier before writing the store). ``cut()`` under the
barrier marks the sequence number the snapshot covers; ``trim(cut)``
after the save removes exactly the covered prefix — a batch accepted
between capture and save survives in the log.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

from siddhi_tpu_torch.analysis.guards import guarded
from siddhi_tpu_torch.analysis.locks import make_lock
from siddhi_tpu_torch.core.event import Event


class _Record:
    __slots__ = ("seq", "stream_id", "kind", "payload", "timestamps", "size")

    def __init__(self, seq, stream_id, kind, payload, timestamps, size):
        self.seq = seq
        self.stream_id = stream_id
        self.kind = kind              # 'events' | 'columns'
        self.payload = payload
        self.timestamps = timestamps
        self.size = size


def _copy_columns(data):
    """Defensive copy: producers reuse/mutate their column buffers."""
    import numpy as np

    out = {}
    for k, v in data.items():
        if hasattr(v, "dtype"):
            out[k] = np.array(v, copy=True)
        else:
            out[k] = list(v)
    return out


def register_wal_gauges(app_context) -> None:
    """Expose the context's attached WAL on its telemetry registry
    (``wal.batches`` / ``wal.pending_events`` / ``wal.dropped_batches``
    on GET /metrics). Called wherever a WAL is ATTACHED to a context —
    ``SiddhiAppRuntime.enable_wal`` and the peer-recovery rebuild
    (``resilience/supervisor.PeerRecovery``). Idempotent (gauges are keyed by
    name)."""
    wal = getattr(app_context, "ingest_wal", None)
    tel = getattr(app_context, "telemetry", None)
    if wal is None or tel is None:
        return
    tel.gauge("wal.batches", wal.__len__)
    tel.gauge("wal.pending_events", lambda w=wal: w.pending_events)
    tel.gauge("wal.dropped_batches", lambda w=wal: w.dropped_batches)


@guarded
class IngestWAL:
    """Per-process bounded ingest log (see module docstring)."""

    # the overflow/shed/replay counters stay undeclared: monotonic,
    # single-writer, read lock-free by gauges and reports
    GUARDED_BY = {"_log": "wal", "_seq": "wal", "_events": "wal"}

    def __init__(self, max_batches: int = 4096,
                 max_events: Optional[int] = None,
                 app_context=None):
        if max_batches <= 0:
            raise ValueError("IngestWAL needs max_batches > 0")
        self.max_batches = int(max_batches)
        self.max_events = max_events
        self.app_context = app_context    # statistics hookup (optional)
        self._log: deque = deque()
        self._lock = make_lock("wal")
        self._seq = 0
        self._events = 0                  # events currently held
        self.dropped_batches = 0          # overflow evictions (lossy!)
        self.shed_records = 0             # admission sheds (discard)
        self.replayed_batches = 0
        self.recorded_batches = 0
        # revision whose snapshot the retained suffix FOLLOWS (set by the
        # checkpoint trim); restore_revision consults it so a restore of
        # an OLDER revision does not graft the suffix onto a stale base
        self.checkpoint_revision: Optional[str] = None
        # highest sequence any checkpoint trim has covered: a restore of a
        # snapshot whose cut predates this must SKIP the replay (the
        # retained suffix follows a newer base) — consulted by the serving
        # tier's per-shard rebuild (serving/sharded_aggregation.py)
        self.checkpoint_seq = 0
        # re-record suppression is scoped to the REPLAYING THREAD only:
        # live ingest accepted concurrently on other threads must still
        # be recorded, or the next failure silently loses it
        self._replay_thread: Optional[int] = None

    def in_replay(self) -> bool:
        """True on the thread currently executing ``replay()`` — consulted
        by the record paths (suppress re-recording) and by the
        InputHandler's @app:enforceOrder watermark (a replayed suffix
        re-enters with its ORIGINAL timestamps, behind the watermark)."""
        return self._replay_thread == threading.get_ident()

    # ------------------------------------------------------------- record

    def record_events(self, stream_id: str,
                      events: List[Event]) -> Optional[int]:
        """Returns the record's sequence number (None when suppressed) —
        the handle ``discard`` takes if admission later sheds the batch
        (``resilience/overload.py``)."""
        if self.in_replay() or not events:
            return None
        copies = [Event(timestamp=e.timestamp, data=list(e.data))
                  for e in events]
        return self._append(_Record(None, stream_id, "events", copies, None,
                                    len(copies)))

    def record_columns(self, stream_id: str, data,
                       timestamps=None) -> Optional[int]:
        if self.in_replay():
            return None
        import numpy as np

        n = 0
        for v in data.values():
            n = len(v)
            break
        ts = np.array(timestamps, np.int64) if timestamps is not None else None
        return self._append(_Record(None, stream_id, "columns",
                                    _copy_columns(data), ts, n))

    def _append(self, rec: _Record) -> int:
        with self._lock:
            self._seq += 1
            rec.seq = self._seq
            self._log.append(rec)
            self._events += rec.size
            self.recorded_batches += 1
            while (len(self._log) > self.max_batches
                   or (self.max_events is not None
                       and self._events > self.max_events
                       and len(self._log) > 1)):
                old = self._log.popleft()
                self._events -= old.size
                self.dropped_batches += 1
                self._count("resilience.wal_dropped_batches")
            return rec.seq

    def discard(self, seq: int) -> bool:
        """Remove one retained record by sequence number — the shed path
        (``resilience/overload.py``): a batch that admission dropped was
        never processed, so replaying it after a restore would resurrect
        events the live run shed. No-op (False) when the record was
        already trimmed or evicted. Replay iterates records, so the seq
        gap this leaves is harmless."""
        with self._lock:
            for i, rec in enumerate(self._log):
                if rec.seq == seq:
                    del self._log[i]
                    self._events -= rec.size
                    self.shed_records += 1
                    return True
        return False

    # ------------------------------------------------- checkpoint protocol

    def cut(self) -> int:
        """Sequence mark of everything a snapshot captured — call while
        holding the app barrier, alongside the state capture."""
        with self._lock:
            return self._seq

    def trim(self, upto_seq: int) -> int:
        """Drop records covered by a durably-saved checkpoint; returns how
        many were trimmed."""
        n = 0
        with self._lock:
            while self._log and self._log[0].seq <= upto_seq:
                rec = self._log.popleft()
                self._events -= rec.size
                n += 1
            if upto_seq > self.checkpoint_seq:
                self.checkpoint_seq = upto_seq
        return n

    def mark_checkpoint(self, revision: Optional[str] = None) -> int:
        """Unconditional trim of the whole log (checkpoint under a held
        barrier, or restore completing — the restored state supersedes);
        records ``revision`` as the base the (now empty) suffix follows."""
        n = self.trim(self.cut())
        if revision is not None:
            self.checkpoint_revision = revision
        return n

    # -------------------------------------------------------------- replay

    def __len__(self) -> int:
        with self._lock:
            return len(self._log)

    @property
    def pending_events(self) -> int:
        with self._lock:
            return self._events

    def records_after(self, seq: int) -> List[_Record]:
        """Retained records with sequence > ``seq`` (oldest first) — the
        suffix a restored snapshot with cut ``seq`` is missing. Used by
        shard-scoped rebuilds that re-fold records directly instead of
        re-sending through input handlers."""
        with self._lock:
            return [r for r in self._log if r.seq > seq]

    def replay(self, app_runtime) -> int:
        """Re-send the retained suffix in arrival order through the given
        runtime's input handlers. Returns the number of replayed batches.
        The records stay in the log (they are still the post-checkpoint
        suffix of the restored state, and must survive a second failure);
        re-recording is suppressed only for THIS wal — a different wal on
        the target runtime correctly records the replay as fresh ingest."""
        with self._lock:
            records = list(self._log)
        self._replay_thread = threading.get_ident()
        try:
            for rec in records:
                h = app_runtime.get_input_handler(rec.stream_id)
                if rec.kind == "events":
                    h.send([Event(timestamp=e.timestamp, data=list(e.data))
                            for e in rec.payload])
                else:
                    h.send_columns(_copy_columns(rec.payload),
                                   timestamps=rec.timestamps)
                self.replayed_batches += 1
                self._count("resilience.wal_replayed_batches")
        finally:
            self._replay_thread = None
        return len(records)

    def _count(self, name: str) -> None:
        from siddhi_tpu_torch.resilience import stat_count

        if self.app_context is not None:
            stat_count(self.app_context, name)
