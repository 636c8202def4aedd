"""Ordered egress: re-merge worker emissions into exact global order.

Counterpart of ``siddhi_tpu/cluster/egress.py``, pure Python. The router
stamps every ingest batch with a global sequence and splits it into
maximal contiguous same-owner row RUNS tagged ``(seq, run)``; each worker
processes its runs in order and reports one completion (wire
``CTRL_SEQ_ACK``) per run, with the run's output rows riding ahead of it.
The merger releases emissions strictly in ``(seq, run)`` order, the exact
order one process fed the same run sequence produces, by holding
completed-but-early tags in a heap and popping while the heap head is the
oldest outstanding tag (the sequence-ordered merge of "Scaling Ordered
Stream Processing on Shared-Memory Multicores", PAPERS.md).

Effectively-once lives here too: a respawned worker REPLAYS its WAL
suffix, so emissions for already-merged tags arrive a second time; the
completed-tag set drops them (``duplicate_emits``), which makes replay
safe to over-deliver: no row lost, no row doubled.
"""

from __future__ import annotations

import heapq
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from siddhi_tpu_torch.analysis.guards import guarded
from siddhi_tpu_torch.analysis.locks import make_lock

Tag = Tuple[int, int]


@guarded
class OrderedEgress:
    """Router-side merge point for worker emissions."""

    GUARDED_BY = {
        "_expected": "egress", "_expected_set": "egress",
        "_ready": "egress", "_pending_rows": "egress",
        "_done": "egress", "rows": "egress",
        "merged_rows": "egress", "merged_runs": "egress",
        "duplicate_emits": "egress",
    }

    def __init__(self):
        self._lock = make_lock("egress")
        self._cv = threading.Condition(self._lock)
        self._expected: deque = deque()     # tags in global send order
        self._expected_set = set()
        self._ready: list = []              # heap of completed early tags
        self._pending_rows: Dict[Tag, list] = {}
        self._done = set()                  # merged tags (replay dedup)
        # (app, stream) -> [(ts, tuple(values)), ...] in global order
        self.rows: Dict[Tuple[str, str], List[Tuple]] = {}
        self.merged_rows = 0
        self.merged_runs = 0
        self.duplicate_emits = 0

    # ------------------------------------------------------------ feeding

    def expect(self, tag: Tag) -> None:
        """Register an outstanding run at SEND time — tags must arrive
        here in global (seq, run) order; that order is the merge's
        ground truth."""
        with self._lock:
            if self._expected and self._expected[-1] >= tag:
                raise ValueError(
                    f"egress tags must be expected in order: {tag} after "
                    f"{self._expected[-1]}")
            self._expected.append(tag)
            self._expected_set.add(tag)

    def emit(self, tag: Tag, app: str, stream: str, rows: List[Tuple]
             ) -> bool:
        """Buffer one run's output rows (worker MSG_EMIT). Rows for a
        replayed, already-merged tag are dropped here (returns False)."""
        with self._lock:
            if tag in self._done or tag not in self._expected_set:
                self.duplicate_emits += 1
                return False
            self._pending_rows.setdefault(tag, []).append(
                (app, stream, rows))
            return True

    def complete(self, tag: Tag) -> bool:
        """Mark one run complete (worker seq-ack) and release every
        emission the global order now admits. False for a replayed ack
        of an already-merged tag."""
        with self._cv:
            if tag in self._done or tag not in self._expected_set:
                return False                # replayed ack: already merged
            self._done.add(tag)
            heapq.heappush(self._ready, tag)
            self._release_locked()
            self._cv.notify_all()
            return True

    def _release_locked(self) -> None:
        """Pop + merge while the heap head is the oldest outstanding
        tag. Caller holds the lock."""
        while (self._expected and self._ready
               and self._ready[0] == self._expected[0]):
            head = heapq.heappop(self._ready)
            self._expected.popleft()
            self._expected_set.discard(head)
            for app, stream, rows in self._pending_rows.pop(head, ()):
                out = self.rows.setdefault((app, stream), [])
                for ts, values in rows:
                    out.append((ts, tuple(values)))
                    self.merged_rows += 1
            self.merged_runs += 1

    def drop_pending(self, tag: Tag) -> None:
        """Discard buffered rows of an INCOMPLETE tag — the worker died
        between emitting and acking it, and the WAL replay is about to
        regenerate those rows; keeping both copies would double them."""
        with self._lock:
            if tag in self._done:
                return
            self._pending_rows.pop(tag, None)

    def forget(self, tag: Tag) -> None:
        """Drop an outstanding HEAD tag that will never complete (e.g. a
        run whose WAL record was lost to overflow — the recovery path
        surfaces that as a counted gap, never a silent hang)."""
        with self._cv:
            if tag not in self._expected_set or tag in self._done:
                return
            self._done.add(tag)
            self._pending_rows.pop(tag, None)    # ONLY the lost tag's rows
            heapq.heappush(self._ready, tag)
            # release through the normal path: later completed tags
            # unblocked by this gap still merge their rows
            self._release_locked()
            self._cv.notify_all()

    # ------------------------------------------------------------ reading

    def outstanding(self) -> int:
        with self._lock:
            return len(self._expected)

    def wait_quiesced(self, timeout: Optional[float] = None) -> bool:
        """Block until every expected run has merged — the checkpoint
        barrier's quiesce point."""
        with self._cv:
            return self._cv.wait_for(lambda: not self._expected,
                                     timeout=timeout)

    def counters(self) -> Dict[str, int]:
        """Merge counters under the lock — status endpoints and tools
        must read through here, never the raw attributes."""
        with self._lock:
            return {"merged_rows": self.merged_rows,
                    "merged_runs": self.merged_runs,
                    "duplicate_emits": self.duplicate_emits}

    def snapshot_rows(self) -> Dict[Tuple[str, str], List[Tuple]]:
        with self._lock:
            return {k: list(v) for k, v in self.rows.items()}

    def stream_rows(self, app: str, stream: str) -> List[Tuple]:
        with self._lock:
            return list(self.rows.get((app, stream), ()))
