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
- **Overload control** (``resilience/overload.py``). An app's
  ``pipeline_quota`` bounds its entries in flight across owners, and
  each submit is a weighted-fair yield point; ``oldest_age_s`` is the
  app supervisor's wedge check.

``FusedCompletion`` is one in-flight batch of a fused fan-out group
(``core/query/fused_fanout.py``): one stacked meta for every member, and
per-member emission and fault attribution at drain, in the members'
subscription order.

Tracing (``observability/tracing.py``): each drain round is a
``pipeline.drain`` span and each wait on an entry's event a ``sync.meta``
span. While the tracer is on, a query's dispatch records a timing event
on its stream before the step (``card_timer``) and the meta's event is a
timing event: once it has completed, at drain, the step's card time goes
into the app registry's histogram ``step.card_ms.<query>``, one value a
dispatch with no wait of its own. It holds the time from the card
reaching the step to the meta's arrival on the host, gaps inside the step
included.

Telemetry: the counters ``pipeline.pulls`` (drain rounds),
``pipeline.metas`` (entries drained) and ``pipeline.stalls`` (forced
drains that waited on the card), beside the pump's own attributes of the
same names, and one gauge ``pipeline.<label>.inflight`` per owner (a
query's name, ``fanout.<stream>`` for a fused group). A batch journey
(``observability/journey.py``) rides its entry: at drain each entry's
event is queried before the wait (is the card still on it?), the wait
is the round's pull, and the emit is timed before the journey finishes.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from siddhi_tpu_torch.analysis.guards import guarded
from siddhi_tpu_torch.analysis.locks import make_lock
from siddhi_tpu_torch.core.stream.junction import FatalQueryError
from siddhi_tpu_torch.observability import journey as journey_mod
from siddhi_tpu_torch.observability.tracing import TRACER, span

log = logging.getLogger(__name__)


class QueryCompletion:
    """One in-flight batch of a query runtime: its output columns (a
    ``LazyColumns`` without the meta), the meta in host memory and the
    event that says when the meta has arrived (None off the card)."""

    __slots__ = ("owner", "out", "meta", "event", "overflow_msg", "junction",
                 "batch", "t0", "wall", "tid", "timer_cb", "journey", "card_t0")

    def __init__(self, owner, out, meta, event, overflow_msg,
                 junction=None, batch=None, journey=None, card_t0=None):
        self.owner = owner
        self.journey = journey            # the batch journey, or None
        self.card_t0 = card_t0            # timing event before the step, or None
        self.out = out
        self.meta = meta                  # host tensor: pinned on the card
        self.event = event                # torch.cuda.Event, or None
        # a string, or a callable of the overflow lane (a join's bitmask)
        self.overflow_msg = overflow_msg
        # the wake-time target: a join side's own timer callback, captured
        # at submit (the runtime's _cur_timer_cb is per-batch state)
        self.timer_cb = getattr(owner, "_cur_timer_cb", None) or owner._timer_cb
        self.junction = junction          # delivering junction (or None)
        # the input batch, kept only when the junction routes errors to
        # a fault stream (@OnError(action='stream')): a drain-time error
        # must publish the failing events there, as the sync path does
        self.batch = batch
        self.t0 = time.perf_counter()
        self.wall = time.monotonic()      # the supervisor's wedge check
        self.tid = threading.get_ident()  # submitting thread (scoped flush)

    @property
    def label(self) -> str:
        return self.owner.name

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
        if self.card_t0 is not None:
            record_card_ms(q, self.card_t0, self.event)
        try:
            try:
                q.decode_meta_suffix(meta)
            except FatalQueryError as routed_err:
                # an exchange overflow is fatal for this batch exactly
                # like a capacity overflow
                return routed_err
            if int(meta[0]) > 0:
                msg = (self.overflow_msg(int(meta[0])) if callable(self.overflow_msg)
                       else self.overflow_msg)
                return FatalQueryError(
                    f"query '{q.name}': {msg} before creating the runtime")
            jr = self.journey
            t_e = time.perf_counter() if jr is not None else None
            q._emit(HostBatch(self.out, size=int(meta[2])))
            if jr is not None:
                jr.emit_ms = (time.perf_counter() - t_e) * 1000.0
                jr.finish(q.app_context, (q.name,))
            if int(meta[1]) >= 0 and q.scheduler is not None:
                # the step's wake time reaches the scheduler at drain, as
                # the reference pump delivers it
                q.scheduler.notify_at(int(meta[1]), self.timer_cb)
            return None
        finally:
            if self.junction is not None:
                # after emit, as the synchronous path times it
                self.junction.record_completion(
                    (time.perf_counter() - self.t0) * 1000.0)


class FusedCompletion:
    """One in-flight junction batch of a fused fan-out group: a single
    stacked ``[n_clusters, 3+]`` meta (pinned on the card, with its event)
    covers every member; per-member emission and attribution run in
    ``FusedFanoutRuntime.complete_entry``."""

    __slots__ = ("owner", "outs", "meta", "event", "members", "cluster_of",
                 "batch", "junction", "t0", "wall", "tid", "journey")

    def __init__(self, owner, outs, meta, event, members, cluster_of, batch,
                 junction=None, journey=None):
        self.owner = owner
        self.journey = journey            # one journey for the group batch
        self.outs = outs                  # per-cluster output columns
        self.meta = meta
        self.event = event
        self.members = members            # member list snapshot (ordering)
        self.cluster_of = cluster_of
        self.batch = batch                # the input batch, for fault routing
        self.junction = junction
        self.t0 = time.perf_counter()
        self.wall = time.monotonic()      # the supervisor's wedge check
        self.tid = threading.get_ident()  # submitting thread (scoped flush)

    @property
    def label(self) -> str:
        return f"fanout.{self.owner.stream_id}"

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def complete(self) -> Optional[Exception]:
        try:
            return self.owner.complete_entry(self, self.meta.numpy())
        finally:
            if self.junction is not None:
                # after per-member emission, as QueryCompletion times it
                self.junction.record_completion(
                    (time.perf_counter() - self.t0) * 1000.0)


@guarded
class CompletionPump:
    """Per-app registry of in-flight device batches (one FIFO per owner).

    Thread contract: ``submit`` and ``flush_owner`` are called with the
    owner's ``_lock`` held (``process_batch`` holds it); ``flush`` takes
    each owner's lock itself. Locks are always taken owner first, then
    the pump's (ranks ``owner`` -> ``pump``, ``analysis/lockorder.py``),
    and the pump's is never held across a wait or an emit.
    """

    # `_n_pending` and `_submits_by_j` stay undeclared: both are
    # lock-free has-work/progress probes read from hot sync paths
    GUARDED_BY = {"_pending": "pump"}

    def __init__(self, app_context):
        self.app_context = app_context
        self._pending: Dict[object, deque] = {}
        self._lock = make_lock("pump")
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
        self._gauged: set = set()   # labels with an inflight gauge

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

    def _inflight_by_label(self, label: str) -> int:
        """Entries in flight under one owner label (the gauge reads it)."""
        with self._lock:
            return sum(1 for dq in self._pending.values() for e in dq
                       if e.label == label)

    def oldest_age_s(self) -> Optional[float]:
        """Age of the oldest in-flight entry, or None: the supervisor's
        wedge check (a meta that never arrives means a hung step)."""
        with self._lock:
            oldest = None
            for dq in self._pending.values():
                if dq and (oldest is None or dq[0].wall < oldest):
                    oldest = dq[0].wall
        if oldest is None:
            return None
        return time.monotonic() - oldest

    def _register_gauge(self, label: str) -> None:
        if label in self._gauged:
            return
        self._gauged.add(label)
        self.app_context.telemetry.gauge(
            f"pipeline.{label}.inflight",
            lambda lbl=label: self._inflight_by_label(lbl))

    # ------------------------------------------------------------- submit

    def submit(self, entry: QueryCompletion) -> None:
        """Hand a dispatched batch to the pipeline (owner lock held). When
        the owner would hold more than ``depth`` batches, the older ones
        drain in one round and the newest keeps riding, so the producer
        goes straight back to packing.

        With overload quotas registered (``resilience/overload.py``) the
        app-wide ``pipeline_quota`` also drains this owner down to its one
        riding entry while the app's total exceeds the quota, which bounds
        the total at ``max(quota, one per active query)`` (another owner's
        lock cannot be taken here: its own submits bound it the same way).
        A fused fan-out group's entry is one entry. Each submit is a
        weighted-fair yield point, so a flooded tenant's dispatches do not
        take the card's slots from its siblings."""
        owner = entry.owner
        ctl = getattr(self.app_context, "overload", None)
        if ctl is not None:
            ctl.throttle(0)     # yield only: usage is charged at delivery
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
            pq = ctl.pipeline_quota if ctl is not None else None
            if pq is not None and over <= 0 and self._n_pending > pq:
                over = 1
        self._register_gauge(entry.label)
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
        with span("pipeline.drain") as sp:
            self._drain_round(owner, keep_newest, forced, sp)

    def _drain_round(self, owner, keep_newest, forced, sp) -> None:
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
            sp.set(owner=take[0].label, entries=n)
            stalled = forced and not take[0].ready()
            if stalled:
                # the producer really waits on the card here: the pipeline
                # is too shallow for this pack/step ratio
                self.stalls += 1
        tel = self.app_context.telemetry
        if stalled:
            tel.count("pipeline.stalls")
        tel.count("pipeline.pulls")
        tel.count("pipeline.metas", n)
        draining.add(id(owner))
        try:
            jt = journey_mod.enabled()
            if jt:
                # the device stage's pivot: is the card still on the batch
                # when the host comes for it (service), or was the output
                # parked waiting (slack)? An event query, no wait
                for e in take:
                    if e.journey is not None:
                        e.journey.pre_drain(e.ready())
                t_pull = time.perf_counter()
            try:
                self._wait(owner, take)
            except Exception as pull_err:  # noqa: BLE001 — a dead peer
                # the bounded pull failed (a dead peer's ClusterPeerError
                # from guarded_pull): route it as a synchronous raise inside
                # a delivery, through EVERY distinct delivering junction of
                # the popped entries (a pattern's FIFO can mix junctions),
                # so each one's supervisor and fault machinery sees it. The
                # entries are lost either way: ClusterPeerError is terminal
                # for this runtime (parallel/distributed.guarded_pull)
                routed = False
                seen = set()
                for e in take:
                    jn = getattr(e, "junction", None)
                    if jn is None or id(jn) in seen:
                        continue
                    seen.add(id(jn))
                    routed = self._route_error(e, pull_err) or routed
                if not routed:
                    raise
                return
            if jt:
                # one wait serves the round: each entry is given its time
                pull_ms = (time.perf_counter() - t_pull) * 1000.0
                for e in take:
                    if e.journey is not None:
                        e.journey.drained(pull_ms)
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

    def _wait(self, owner, take) -> None:
        """Wait for the round's metas; a runtime with a mesh recorded
        (``_shard_mesh``) under ``siddhi_tpu.cluster_step_timeout`` waits
        through ``guarded_pull``, bounded."""
        timeout = getattr(self.app_context, "cluster_step_timeout", None)
        if timeout is not None and getattr(owner, "_shard_mesh", None) is not None:
            from siddhi_tpu_torch.parallel.distributed import guarded_pull

            name = getattr(owner, "name", None) or getattr(owner, "stream_id", "?")
            with span("sync.meta", query=name, entries=len(take)):
                guarded_pull([e.meta for e in take], float(timeout),
                             what=f"query '{name}' pipeline drain",
                             wait=lambda: [e.wait() for e in take])
            return
        for e in take:
            with span("sync.meta", query=e.label):
                e.wait()

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


def stage_meta(meta: torch.Tensor, timed: bool = False):
    """The step's ``__meta__`` on its way to the host: on the card, one
    ``non_blocking`` copy into a fresh pinned buffer and an event recorded
    after it on the current stream (a timing event where ``timed``: the
    end of the step's card time); on the CPU the tensor itself."""
    if meta.device.type != "cuda":
        return meta, None
    host = torch.empty(meta.shape, dtype=meta.dtype, pin_memory=True)
    host.copy_(meta, non_blocking=True)
    ev = torch.cuda.Event(enable_timing=True) if timed else torch.cuda.Event()
    ev.record()
    return host, ev


def card_timer(device) -> Optional["torch.cuda.Event"]:
    """While the span tracer is on, a timing event recorded now on the
    current stream of ``device`` (a card); else None, and nothing made."""
    if not TRACER.enabled or device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def record_card_ms(query, start, end) -> None:
    """The card time from ``start`` to ``end`` (timing events) into the
    query's ``step.card_ms.<query>`` histogram, where ``end`` has
    completed (after the wait for the meta it has: no wait here)."""
    if end.query():
        query.app_context.telemetry.histogram(
            f"step.card_ms.{query.name}").record(start.elapsed_time(end))
