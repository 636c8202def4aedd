"""CompletionPump: a depth-bounded software pipeline for device batches.

Counterpart of ``siddhi_tpu/core/query/completion.py``. A query step
enqueues its work on the card and returns; instead of waiting for the
step's packed ``__meta__`` ([overflow, notify, count, ...]) before the
next batch is packed, the runtime hands the step's output to the app's
pump, and up to ``pipeline_depth`` batches per query ride in flight while
the producer packs the next one. Depth 1 bypasses the pump: every step
pulls its meta at once, as before the pump existed.

On the card each in-flight batch holds its meta copied ``non_blocking``
into a pinned host buffer and a CUDA event recorded after that copy on
the step's stream: ``ready()`` is ``event.query()``, and a drain waits on
the events, then reads the pinned metas. (A ``non_blocking`` copy into
pageable memory is silently synchronous.) The batch's output tensors stay
referenced by its completion until drain; the sinks and callbacks that
read them run then, never inside the dispatch.

Contract:

- **Per-owner dispatch order.** Each owner (a ``QueryRuntime``) has a
  FIFO of in-flight completions; drains pop strictly from the head, so
  emission per query always follows dispatch order. No order is promised
  across queries.
- **Batched drain rounds.** A drain completes every popped entry after
  one wait on their events; ``pulls`` and ``metas`` count rounds and
  entries.
- **Overflow surfaces on the producer's next send.** A capacity overflow
  found at drain raises ``FatalQueryError`` out of whoever drained: the
  producer's own submit or flush (synchronous sends), or an @Async
  worker's idle flush, whose junction then re-raises it on every later
  send. The other entries of the round still emit; the overflowed batch
  does not (the synchronous path raises before it emits).
- **Prompt completion.** Synchronous junction sends flush the pump
  before they return; @Async workers flush when their queue goes idle
  and on exit.
- **Completion latency feedback.** At drain, each entry's true
  dispatch->emit time feeds its junction's ``latency.target`` loop.

``FusedCompletion`` (fan-out fusion) waits for ROADMAP A.8; telemetry
gauges and the journey tracer for A.10.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from siddhi_tpu_torch.core.stream.junction import FatalQueryError

log = logging.getLogger(__name__)


class QueryCompletion:
    """One in-flight batch of a query runtime: its output columns (a
    ``LazyColumns`` without the meta), the meta in host memory and the
    event that says when the meta has arrived (None off the card)."""

    __slots__ = ("owner", "out", "meta", "event", "overflow_msg", "junction",
                 "batch", "t0", "tid")

    def __init__(self, owner, out, meta, event, overflow_msg: str,
                 junction=None, batch=None):
        self.owner = owner
        self.out = out
        self.meta = meta                  # host tensor: pinned on the card
        self.event = event                # torch.cuda.Event, or None
        self.overflow_msg = overflow_msg
        self.junction = junction          # delivering junction (or None)
        # the input batch, kept only when the junction routes errors to
        # a fault stream (@OnError(action='stream')): a drain-time error
        # must publish the failing events there, as the sync path does
        self.batch = batch
        self.t0 = time.perf_counter()
        self.tid = threading.get_ident()  # submitting thread (scoped flush)

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def complete(self) -> Optional[Exception]:
        """Emit the batch from its (arrived) meta; returns the error its
        meta reports, or raises what emission raised."""
        from siddhi_tpu_torch.core.event import HostBatch

        q = self.owner
        meta = self.meta.numpy()
        try:
            try:
                q.decode_meta_suffix(meta)
            except FatalQueryError as routed_err:
                # an exchange overflow is fatal for this batch exactly
                # like a capacity overflow
                return routed_err
            if int(meta[0]) > 0:
                return FatalQueryError(
                    f"query '{q.name}': {self.overflow_msg} before "
                    f"creating the runtime")
            q._emit(HostBatch(self.out, size=int(meta[2])))
            return None
        finally:
            if self.junction is not None:
                # after emit, as the synchronous path times it
                self.junction.record_completion(
                    (time.perf_counter() - self.t0) * 1000.0)


class CompletionPump:
    """Per-app registry of in-flight device batches (one FIFO per owner).

    Thread contract: ``submit`` and ``flush_owner`` are called with the
    owner's ``_lock`` held (``process_batch`` holds it); ``flush`` takes
    each owner's lock itself. Locks are always taken owner first, then
    the pump's, and the pump's is never held across a wait or an emit.
    """

    def __init__(self, app_context):
        self.app_context = app_context
        self._pending: Dict[object, deque] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._n_pending = 0       # cheap has-work probe for sync senders
        # per delivering junction: lets a worker tell whether ITS delivery
        # pipelined (junction._timed)
        self._submits_by_j: Dict[int, int] = {}
        # what the pipeline did: drain rounds, entries drained, forced
        # drains that had to wait on the card, the most entries one owner
        # held at once
        self.pulls = 0
        self.metas = 0
        self.stalls = 0
        self.high_water = 0

    # ------------------------------------------------------------- config

    @property
    def depth(self) -> int:
        return max(1, int(getattr(self.app_context, "pipeline_depth", 1)))

    @property
    def has_pending(self) -> bool:
        return self._n_pending > 0

    def submits_of(self, junction) -> int:
        return self._submits_by_j.get(id(junction), 0)

    def inflight(self, owner) -> int:
        with self._lock:
            dq = self._pending.get(owner)
            return len(dq) if dq is not None else 0

    # ------------------------------------------------------------- submit

    def submit(self, entry: QueryCompletion) -> None:
        """Hand a dispatched batch to the pipeline (owner lock held). When
        the owner would hold more than ``depth`` batches, the older ones
        drain in one round and the newest keeps riding, so the producer
        goes straight back to packing."""
        owner = entry.owner
        with self._lock:
            dq = self._pending.setdefault(owner, deque())
            dq.append(entry)
            self._n_pending += 1
            self.high_water = max(self.high_water, len(dq))
            j = entry.junction
            if j is not None:
                self._submits_by_j[id(j)] = self._submits_by_j.get(id(j), 0) + 1
            # per thread: flush() loops only while THIS thread's own emit
            # cascades keep producing entries
            self._tls.submitted = getattr(self._tls, "submitted", 0) + 1
            over = len(dq) - self.depth
        if over > 0:
            self._drain_owner(owner, keep_newest=1, forced=True)

    # -------------------------------------------------------------- drain

    def _draining(self) -> set:
        s = getattr(self._tls, "draining", None)
        if s is None:
            s = self._tls.draining = set()
        return s

    def _drain_owner(self, owner, keep_newest: Optional[int],
                     forced: bool = False) -> None:
        """Pop entries from ``owner``'s FIFO head and complete them in
        order after one wait on their events (caller holds
        ``owner._lock``). Re-entrant submits for the SAME owner (a query
        feeding its own input stream) queue behind the round in progress
        and the outer flush picks them up."""
        draining = self._draining()
        if id(owner) in draining:
            return
        with self._lock:
            dq = self._pending.get(owner)
            if not dq:
                return
            n = len(dq) - (keep_newest or 0)
            if n <= 0:
                return
            take = [dq.popleft() for _ in range(n)]
            self._n_pending -= n
            if not dq:
                del self._pending[owner]
            self.pulls += 1
            self.metas += n
            if forced and not take[0].ready():
                # the producer really waits on the card here: the pipeline
                # is too shallow for this pack/step ratio
                self.stalls += 1
        draining.add(id(owner))
        try:
            for e in take:
                e.wait()
            errors: List[Exception] = []
            for e in take:
                try:
                    err = e.complete()
                except Exception as raised:  # noqa: BLE001 — drain-then-raise
                    err = raised
                if err is not None and not self._route_error(e, err):
                    errors.append(err)
            if errors:
                for extra in errors[1:]:
                    log.error("pipeline drain: additional error suppressed "
                              "behind the raised one: %r", extra)
                raise errors[0]
        finally:
            draining.discard(id(owner))

    @staticmethod
    def _route_error(entry, err: Exception) -> bool:
        """Route a drain error through the entry's OWN delivering junction
        (the drain may have been triggered by an unrelated send). True
        when the routing absorbed it (logged, dropped or published to the
        fault stream, the synchronous path's per-receiver semantics);
        False when the drain must raise it (framework fatals, which
        ``handle_error`` re-raises after storing them on the junction,
        and errors of entries that have no junction)."""
        j = entry.junction
        if j is None:
            return False
        events = []
        if entry.batch is not None:
            try:
                events = j.decode_events(entry.batch)
            except Exception:  # noqa: BLE001 — routing must not mask
                events = []
        if not events and not isinstance(err, FatalQueryError):
            log.error("pipeline drain error on stream '%s' (input events not "
                      "retained past dispatch): %r", j.definition.id, err)
        try:
            j.handle_error(events, err)
        except Exception:  # noqa: BLE001 — fatal: raised by the drain
            return False
        return True

    # -------------------------------------------------------------- flush

    def flush_owner(self, owner) -> None:
        """Drain everything of one owner (owner lock held)."""
        self._drain_owner(owner, keep_newest=None)

    def flush(self, own_only: bool = False) -> None:
        """Drain owners to empty. Synchronous sends and @Async workers'
        per-unit flushes pass ``own_only=True``: only owners holding an
        entry THIS thread submitted (its dispatches and their emit
        cascades). Nested flushes inside an emit cascade are no-ops; the
        outer flush loops until this thread submits nothing new."""
        if self._n_pending == 0:
            return
        if getattr(self._tls, "in_flush", False) or self._draining():
            # inside a drain round this thread holds that owner's lock:
            # taking another owner's lock here could deadlock against a
            # worker doing the mirror-image cascade; the caller's own
            # flush picks the entries up
            return
        self._tls.in_flush = True
        ident = threading.get_ident()
        try:
            while True:
                with self._lock:
                    owners = [o for o, dq in self._pending.items()
                              if dq and (not own_only
                                         or any(en.tid == ident for en in dq))]
                if not owners:
                    return
                submitted0 = getattr(self._tls, "submitted", 0)
                for owner in owners:
                    with owner._lock:
                        self._drain_owner(owner, keep_newest=None)
                if getattr(self._tls, "submitted", 0) == submitted0:
                    return
        finally:
            self._tls.in_flush = False

    def discard_all(self) -> None:
        """Drop every in-flight entry without emitting."""
        with self._lock:
            self._pending.clear()
            self._n_pending = 0


def stage_meta(meta: torch.Tensor):
    """The step's ``__meta__`` on its way to the host: on the card, one
    ``non_blocking`` copy into a fresh pinned buffer and an event recorded
    after it on the current stream; on the CPU the tensor itself."""
    if meta.device.type != "cuda":
        return meta, None
    host = torch.empty(meta.shape, dtype=meta.dtype, pin_memory=True)
    host.copy_(meta, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev
