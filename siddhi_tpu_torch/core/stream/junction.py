"""StreamJunction: per-stream pub/sub bus.

Counterpart of ``siddhi_tpu/core/stream/junction.py``: producers publish
event chunks or columnar batches and every subscribed receiver (query
runtimes, stream callbacks, sinks) gets them in subscription order.

- Synchronous junctions deliver on the caller's thread, then drain the
  app's ``CompletionPump`` of this thread's pipelined batches before the
  send returns, so a caller observes its outputs at once at any
  ``pipeline_depth``.
- ``@Async`` (``enable_async``): a bounded queue and one worker thread
  that re-batches event chunks up to an adaptive cap (``max.delay``,
  ``latency.target``) and delivers columnar batches as they come. The
  worker enters the app's CUDA device: the current device and stream are
  per thread, and every step of a query must run on the one stream whose
  order keeps its in-place state right. It drains the pump whenever its
  queue goes idle and as its last act.
- ``@OnError(action='stream')``: events whose processing failed go to
  the ``!S`` fault junction with an appended ``_error`` string; the
  default logs and drops them. ``FatalQueryError`` and ``CompileError``
  always reach the sender, and on an ``@Async`` junction a stored fatal
  error re-raises on every later send.

Under ``@app:statistics`` each publish counts its events on the stream's
throughput tracker, and each @Async delivery's latency lands in the
``junction.<stream>`` tracker. Whatever the statistics level, an @Async
junction registers the gauges ``junction.<s>.queue_depth`` and
``junction.<s>.inflight_batches``, and counts
``junction.<s>.backpressure_stalls`` (a producer met a full queue) and
``junction.<s>.enqueue_timeouts`` (it waited out a timeout). Every
delivery is a ``junction.dispatch`` span (``observability/tracing.py``);
with batch journeys on (``observability/journey.py``) a queued unit
carries its enqueue time, and its receivers read the queue residence
for the delivery's scope. The worker polls ``fault_hook``
(``resilience/faults.py``) at the top of each drain iteration: a hook
may block (a wedge) or raise (the worker dies, and its unit stays parked
for ``restart_worker``).

Resilience and overload (``resilience/supervisor.py``,
``resilience/overload.py``): the worker bumps ``_beats`` each drain
iteration (the supervisor's heartbeat; an idle worker beats every
``_IDLE_POLL_S``). With quotas registered (``app_context.overload``), an
@Async enqueue passes ``admit`` first: past the queue quota the stream's
shed policy drops a unit and discards its WAL record, whose sequence
number the input handler hands over (``wal_seq``), or blocks, bounded.
A producer's blocked put escalates every ``block_timeout_s`` to the
supervisor, which replaces a dead or wedged worker, with or without
quotas. Each delivery is a fair-share yield point, and every processing
error is shown to the supervisor (``notify_error``).

The autopilot's fusion actuator rewires the receivers through
``defer_mutation``: the delivering thread runs the mutation before it
fans its next batch out, so the receiver list never changes mid-delivery.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
import traceback
from typing import List, Optional

from siddhi_tpu_torch.analysis.guards import guarded
from siddhi_tpu_torch.analysis.locks import make_lock
from siddhi_tpu_torch.core.event import Event, HostBatch, LazyColumns
from siddhi_tpu_torch.observability import journey
from siddhi_tpu_torch.observability.tracing import span
from siddhi_tpu_torch.query_api.definitions import StreamDefinition

log = logging.getLogger(__name__)

# marker for "no unit in flight" (None is the queue's stop sentinel)
_NOTHING = object()

# the junction whose delivery loop runs on THIS thread: receivers reached
# through the Event path (Receiver.receive has no junction parameter)
# read it so their pipelined completions know their delivering junction
_DELIVERING = threading.local()

# the worker polls its queue with this bound, so an idle worker drains
# the pipeline within one poll and beats at least ~10 times a second (the
# supervisor's wedge timeout is clamped to a multiple of it)
_IDLE_POLL_S = 0.1


def current_delivering_junction() -> Optional["StreamJunction"]:
    return getattr(_DELIVERING, "junction", None)


class FatalQueryError(RuntimeError):
    """Framework-infrastructure failure (capacity overflow knobs): unlike
    per-event processing errors, which the junction logs or routes per
    @OnError, these always propagate to the sender."""


class Receiver:
    """Subscriber interface (reference StreamJunction.Receiver)."""

    def receive(self, events: List[Event]):
        raise NotImplementedError

    def receive_batch(self, batch, junction: "StreamJunction"):
        """Columnar fast path: receivers that consume a HostBatch directly
        override this; the default decodes to Events."""
        self.receive(junction.decode_events(batch))


@guarded
class StreamJunction:
    # the adaptive cap and its latency average (analysis/guards.py)
    GUARDED_BY = {"_lat_ewma": "adapt", "_cur_batch": "adapt"}

    def __init__(self, definition: StreamDefinition, app_context,
                 fault_junction: Optional["StreamJunction"] = None):
        self.definition = definition
        self.app_context = app_context
        self.receivers: List[Receiver] = []
        self.fault_junction = fault_junction
        self.on_error_action = "LOG"    # LOG | STREAM (from @OnError)
        self._async = False
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._batch_size = 256
        self._max_delay_s: Optional[float] = None
        self._latency_target_ms: Optional[float] = None
        # the adaptive cap and its latency average are read-modify-written
        # by the worker and by whichever thread drains the pump
        self._adapt_lock = make_lock("adapt")
        self._cur_batch = 256
        self._lat_ewma = 0.0
        self._running = False
        self._fatal: Optional[Exception] = None
        # the unit the worker is delivering, kept for a replacement worker
        # (restart_worker); the generation retires a superseded worker
        self._inflight = _NOTHING
        self._inflight_owner: Optional[threading.Thread] = None
        self._gen = 0
        # the supervisor's liveness counter: bumped each drain iteration,
        # read without a lock
        self._beats = 0
        # the fault-injection point the drain loop polls
        # (resilience/faults.py)
        self.fault_hook = None
        # overload control: queued unit id -> its ingest-WAL sequence
        # number, so a shed unit's record can be discarded (filled only
        # while units with a WAL record wait in an @Async queue)
        self._wal_seq_of: dict = {}
        # batch journeys: queued unit id -> its enqueue time, so the worker
        # can attribute the queue residence (empty unless journeys are on)
        self._jt_enq: dict = {}
        # deferred receiver-set mutations (the autopilot's fusion
        # actuator): drained by the delivering thread before it fans a
        # batch out, so the receiver list is never rewired mid-iteration
        self._pending_mutations: List = []

    def defer_mutation(self, fn) -> None:
        """Schedule ``fn()`` to run on the next delivering thread before it
        iterates the receivers: the one point where the receiver set may be
        rewired live (a fused group dissolved or re-formed). A junction
        that never delivers again never applies it."""
        self._pending_mutations.append(fn)

    def _drain_mutations(self) -> None:
        while self._pending_mutations:
            fn = self._pending_mutations.pop(0)
            try:
                fn()
            except Exception:  # noqa: BLE001 — a failed rewire must not
                # poison the delivery that happened to drain it
                log.exception("deferred receiver mutation failed on stream '%s'",
                              self.definition.id)

    def subscribe(self, receiver: Receiver):
        if receiver not in self.receivers:
            self.receivers.append(receiver)

    def replace_receivers(self, members: List[Receiver], group: Receiver):
        """Swap a contiguous run of subscribed receivers for ONE fused
        receiver at the run's position (fan-out fusion,
        ``core/plan/fanout_plan.py``): every other subscriber keeps its
        delivery slot, so callback and sink order is unchanged."""
        i = self.receivers.index(members[0])
        for m in members:
            self.receivers.remove(m)
        self.receivers.insert(i, group)

    # ------------------------------------------------------------ @Async

    def enable_async(self, buffer_size: int = 1024, batch_size: int = 256,
                     max_delay_ms: Optional[float] = None,
                     latency_target_ms: Optional[float] = None):
        """@Async: decouple producers via a bounded queue + one worker that
        re-batches event chunks up to ``batch_size``.

        - ``max.delay``: a partial batch waits at most this long for more
          events before delivering.
        - ``latency.target``: each delivery is timed (a pipelined one at
          drain, through ``record_completion``); when the smoothed latency
          overshoots the target the cap halves (floor 16), and under half
          the target it climbs 25% back toward ``batch_size``."""
        self._async = True
        self._batch_size = batch_size
        self._max_delay_s = (max_delay_ms / 1000.0
                             if max_delay_ms is not None else None)
        self._latency_target_ms = latency_target_ms
        with self._adapt_lock:
            self._cur_batch = batch_size
            self._lat_ewma = 0.0
        self._queue = queue.Queue(maxsize=buffer_size)
        # level-independent: a wedging queue shows whatever the
        # statistics level
        tel = self.app_context.telemetry
        sid = self.definition.id
        tel.gauge(f"junction.{sid}.queue_depth", self._queue.qsize)
        tel.gauge(f"junction.{sid}.inflight_batches",
                  lambda j=self: 0 if j._inflight is _NOTHING else 1)

    def start_processing(self):
        self._running = True
        if self._async and self._worker is None:
            self._start_worker()

    def _start_worker(self):
        self._gen += 1
        self._worker = threading.Thread(
            target=self._drain, args=(self._gen,), daemon=True,
            name=f"junction-{self.definition.id}-g{self._gen}")
        self._worker.start()

    def restart_worker(self):
        """Replace a dead or wedged worker: the queue and any unit in
        delivery stay; the generation bump makes a stale worker that later
        wakes exit without delivering twice."""
        if not (self._async and self._running):
            return
        self._start_worker()

    def stop_processing(self):
        self._running = False
        worker, self._worker = self._worker, None
        if worker is None:
            return
        if self._fatal is None:
            self._queue.put(None)
        else:
            # the worker died on a fatal error and producers may have
            # filled the queue: a blocking put would hang shutdown
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass
        worker.join(timeout=5)

    # ----------------------------------------------------------- sending

    def _count_throughput(self, n: int):
        sm = self.app_context.statistics_manager
        if sm is not None and sm.level >= 1:
            sm.throughput_tracker(self.definition.id).add(n)

    def send_events(self, events: List[Event], wal_seq: Optional[int] = None):
        """``wal_seq``: the sequence number of the batch's WAL record,
        discarded if overload admission sheds the batch."""
        if not events:
            return
        self._count_throughput(len(events))
        if self._fatal is not None:
            # the async worker died on a framework failure: surface it to
            # the producer instead of blocking on a queue nobody drains
            raise self._fatal
        if self._async and self._running:
            self._enqueue(events, wal_seq)
        else:
            self._deliver(events)
            # synchronous sends keep synchronous semantics: batches the
            # receivers pipelined drain before the send returns
            self._flush_pipeline(own_only=True)

    def send_batch(self, batch, wal_seq: Optional[int] = None):
        """Columnar publish (no Event objects), delivered as one unit;
        @Async junctions enqueue it behind pending event chunks."""
        self._count_throughput(int(batch.size))
        if self._fatal is not None:
            raise self._fatal
        if self._async and self._running:
            self._enqueue(batch, wal_seq)
        else:
            self._deliver_batch(batch)
            self._flush_pipeline(own_only=True)

    def decode_events(self, batch) -> List[Event]:
        return batch.to_events(
            [(a.name, a.type) for a in self.definition.attributes],
            self.app_context.string_dictionary,
            object_meta=getattr(self.definition, "object_elem_types", None),
            object_multi=getattr(self.definition, "object_multi_attrs", None))

    def _flush_pipeline(self, own_only: bool = False):
        """Drain the app's CompletionPump (a no-op when it is empty or
        when this is a nested flush inside an emit cascade). ``own_only``
        (synchronous senders) drains this thread's dispatches only."""
        pump = getattr(self.app_context, "completion_pump", None)
        if pump is None or not pump.has_pending:
            return
        pump.flush(own_only=own_only)

    def _enqueue(self, item, wal_seq: Optional[int] = None):
        """Producer side of @Async. With quotas registered, admission
        runs first: past the queue quota the stream's shed policy applies
        (a shed unit is counted and its WAL record discarded; ``block``
        waits, bounded, escalating to the supervisor). The blocking put
        that follows is bounded too: it re-checks the worker's fatal
        error each slice and escalates every ``block_timeout_s``, so a
        wedged consumer is replaced instead of parking the producer."""
        from siddhi_tpu_torch.resilience import overload

        ctl = getattr(self.app_context, "overload", None)
        if ctl is not None and not ctl.admit(self, item, wal_seq):
            return                  # shed: counted, its WAL record discarded
        if wal_seq is not None:
            # mapped before the put: once queued, the worker (or a
            # shed_oldest eviction) may pop the unit at once
            self._wal_seq_of[id(item)] = wal_seq
        if journey.enabled():
            # the queue-residence stamp, before the put. At most qsize
            # stamps are live, so past that bound the oldest are stale:
            # drop those only
            live_cap = (self._queue.maxsize or 8192) + 256
            while len(self._jt_enq) > live_cap:
                try:
                    self._jt_enq.pop(next(iter(self._jt_enq)), None)
                except (StopIteration, RuntimeError):
                    break
            self._jt_enq[id(item)] = time.perf_counter()
        try:
            self._queue.put_nowait(item)
            return
        except queue.Full:
            pass
        tel = self.app_context.telemetry
        tel.count(f"junction.{self.definition.id}.backpressure_stalls")
        timeout_s = (ctl.block_timeout_s if ctl is not None
                     else overload.DEFAULT_BLOCK_TIMEOUT_S)
        waited = 0.0
        while True:
            try:
                self._queue.put(item, timeout=overload.BLOCK_PUT_SLICE_S)
                return
            except queue.Full:
                pass
            if self._fatal is not None:
                self._forget_unit(item)
                raise self._fatal
            waited += overload.BLOCK_PUT_SLICE_S
            if waited >= timeout_s:
                waited = 0.0
                if ctl is not None:
                    ctl.escalate(self)
                else:
                    self._escalate_default()

    def _escalate_default(self) -> None:
        """The bounded wait's escalation for an app without quotas: the
        blocked producer is counted and logged, and the supervisor gets
        its chance to replace a wedged consumer."""
        from siddhi_tpu_torch.resilience import stat_count

        self.app_context.telemetry.count(
            f"junction.{self.definition.id}.enqueue_timeouts")
        stat_count(self.app_context, "resilience.enqueue_timeouts")
        sup = getattr(self.app_context, "supervisor", None)
        if sup is not None:
            try:
                sup.notify_backpressure(self)
                return
            except Exception:  # noqa: BLE001 — escalation must not mask
                log.exception("backpressure escalation failed")
        log.warning(
            "producer blocked on full @Async queue of stream '%s': the "
            "consumer is not draining (a wedged worker? rt.supervise() "
            "replaces it)", self.definition.id)

    def _forget_unit(self, item) -> Optional[int]:
        """A queued unit that will never be delivered (shed, or its
        producer gave up): drop its journey stamp and return its WAL
        sequence number, if it had one."""
        if self._jt_enq:
            self._jt_enq.pop(id(item), None)
        return self._wal_seq_of.pop(id(item), None) if self._wal_seq_of else None

    def _dequeued(self, item):
        """The worker took ``item`` for delivery: its WAL record now
        stands (no shed can reach it) and its journey stamp is read."""
        if self._wal_seq_of:
            self._wal_seq_of.pop(id(item), None)
        return self._jt_enq.pop(id(item), None) if self._jt_enq else None

    # ---------------------------------------------------------- delivery

    def _deliver(self, events: List[Event], enq_t=None):
        if self._pending_mutations:
            self._drain_mutations()
        with span("junction.dispatch", stream=self.definition.id,
                  rows=len(events)):
            prev = current_delivering_junction()
            _DELIVERING.junction = self
            jt = journey.enabled()
            # the queue-residence scope: receivers of THIS delivery read
            # it; a nested synchronous delivery (an emit cascade) masks it
            prev_q = journey.push_delivery_queue_wait(enq_t) if jt else None
            try:
                for r in self.receivers:
                    try:
                        r.receive(events)
                    except Exception as e:  # noqa: BLE001 — per-event fault routing
                        self.handle_error(events, e)
            finally:
                _DELIVERING.junction = prev
                if jt:
                    journey.pop_delivery_queue_wait(prev_q)

    def _deliver_batch(self, batch, enq_t=None):
        if self._pending_mutations:
            self._drain_mutations()
        with span("junction.dispatch", stream=self.definition.id,
                  rows=int(batch._size) if batch._size is not None else -1):
            prev = current_delivering_junction()
            _DELIVERING.junction = self
            jt = journey.enabled()
            prev_q = journey.push_delivery_queue_wait(enq_t) if jt else None
            try:
                for r in self.receivers:
                    # receivers mutate batch.cols in place (filters, key
                    # columns): each gets its own dict; LazyColumns keeps
                    # device-held outputs unpulled until read
                    try:
                        sub = HostBatch(LazyColumns(batch.cols), size=batch._size)
                        # the pack stamp rides along; each receiver forks
                        # its own journey (journey.begin)
                        sub.journey = batch.journey
                        r.receive_batch(sub, self)
                    except Exception as e:  # noqa: BLE001 — per-event fault routing
                        self.handle_error(self.decode_events(batch), e)
            finally:
                _DELIVERING.junction = prev
                if jt:
                    journey.pop_delivery_queue_wait(prev_q)

    def record_completion(self, elapsed_ms: float):
        """The deliver->emit time of a pipelined batch, from the pump at
        drain: the worker's own timing saw only the dispatch."""
        self._adapt(elapsed_ms)

    def _adapt(self, elapsed_ms: float):
        """latency.target control loop: average the delivery latency,
        halve the cap on overshoot, regrow it under half the target. Every
        @Async delivery's latency also lands in the junction's statistics
        tracker."""
        sm = self.app_context.statistics_manager
        if sm is not None and sm.level >= 1:
            sm.latency_tracker(f"junction.{self.definition.id}").record(elapsed_ms)
        target = self._latency_target_ms
        if target is None:
            return
        with self._adapt_lock:
            self._lat_ewma = (0.7 * self._lat_ewma + 0.3 * elapsed_ms
                              if self._lat_ewma else elapsed_ms)
            if self._lat_ewma > target:
                self._cur_batch = max(16, self._cur_batch // 2)
                self._lat_ewma = target  # re-converge from the new cap
            elif (self._lat_ewma < target / 2
                  and self._cur_batch < self._batch_size):
                self._cur_batch = min(self._batch_size,
                                      max(self._cur_batch + 1,
                                          int(self._cur_batch * 1.25)))

    def _pump_submits(self) -> int:
        pump = getattr(self.app_context, "completion_pump", None)
        return pump.submits_of(self) if pump is not None else 0

    def _timed(self, deliver, unit, enq_t=None):
        """Deliver one unit and feed its latency to the control loop,
        unless it pipelined (its dispatch returned at once;
        ``record_completion`` supplies the true sample at drain). With
        quotas registered the delivery is a weighted-fair yield point: a
        worker of an app over its fair share yields briefly while a
        sibling app is backlogged."""
        ctl = getattr(self.app_context, "overload", None)
        if ctl is not None:
            if isinstance(unit, list):
                ctl.throttle(len(unit))
            else:
                n = unit._size    # a known count only: never a pull
                ctl.throttle(int(n) if n is not None else 1)
        t0 = time.perf_counter()
        n0 = self._pump_submits()
        deliver(unit, enq_t)
        if self._pump_submits() == n0:
            self._adapt((time.perf_counter() - t0) * 1000.0)

    def _device_scope(self):
        """The app's CUDA device for the worker thread (a new thread
        starts on device 0, with the default stream)."""
        import torch

        dev = getattr(self.app_context, "device", None)
        if dev is not None and dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def _drain(self, gen: int):
        with self._device_scope():
            self._drain_loop(gen)

    def _drain_loop(self, gen: int):
        while True:
            self._beats += 1
            hook = self.fault_hook
            if hook is not None:
                # the fault-injection point: a hook may block (a wedge) or
                # raise (the worker dies; its unit stays parked for the
                # replacement worker)
                try:
                    hook(self)
                except Exception as e:  # noqa: BLE001 — an injected death
                    log.warning("junction '%s' worker killed: %s",
                                self.definition.id, e)
                    return
            if gen != self._gen:
                return     # superseded by restart_worker
            enq_t = None
            if self._inflight is not _NOTHING:
                owner = self._inflight_owner
                if (owner is not None and owner.is_alive()
                        and owner is not threading.current_thread()):
                    # a superseded but alive predecessor still delivers
                    # the unit: adopting it would deliver it twice
                    time.sleep(_IDLE_POLL_S)
                    continue
                item = self._inflight     # the predecessor died with it
                self._inflight_owner = threading.current_thread()
            else:
                try:
                    item = self._queue.get(timeout=_IDLE_POLL_S)
                    enq_t = self._dequeued(item)
                except queue.Empty:
                    # idle: drain the batches still riding the pipeline,
                    # which bounds emission lag under trickle load
                    self._flush_pipeline()
                    if not self._running and self._queue.empty():
                        return
                    continue
                self._inflight = item
                self._inflight_owner = threading.current_thread()
                if gen != self._gen:
                    return   # superseded mid-fetch: the unit is handed over
            if item is None:
                self._inflight = _NOTHING
                self._flush_pipeline()   # nothing rides past shutdown
                return
            if not isinstance(item, list):
                # a columnar batch: one pre-formed unit, never split
                self._timed(self._deliver_batch, item, enq_t)
                self._inflight = _NOTHING
                if self._queue.empty():
                    self._flush_pipeline()
                continue
            batch = list(item)
            self._inflight = batch    # coalesced extras ride the same unit
            deadline = (time.perf_counter() + self._max_delay_s
                        if self._max_delay_s is not None else None)
            stop_after = False
            follow = None             # a columnar batch that ended coalescing
            follow_enq = None
            with self._adapt_lock:
                cap = self._cur_batch
            while len(batch) < cap:
                try:
                    if deadline is None:
                        more = self._queue.get_nowait()
                    else:
                        wait = deadline - time.perf_counter()
                        if wait <= 0:
                            break
                        more = self._queue.get(timeout=min(wait, _IDLE_POLL_S))
                except queue.Empty:
                    if deadline is None or time.perf_counter() >= deadline:
                        break
                    # a worker waiting out a long max.delay is healthy
                    self._beats += 1
                    continue
                more_enq = self._dequeued(more)
                if more is None:
                    stop_after = True
                    break
                if not isinstance(more, list):
                    follow, follow_enq = more, more_enq
                    break
                batch.extend(more)
            if gen != self._gen and follow is None and not stop_after:
                return   # superseded while coalescing: the unit stays parked
            # coalesced chunks keep the first chunk's stamp: the unit's
            # longest residence
            self._timed(self._deliver, batch, enq_t)
            if follow is not None:
                self._inflight = follow
                self._timed(self._deliver_batch, follow, follow_enq)
            self._inflight = _NOTHING
            if stop_after or self._queue.empty():
                self._flush_pipeline()
            if stop_after:
                return

    # ------------------------------------------------------------ errors

    def handle_error(self, events: List[Event], e: Exception):
        from siddhi_tpu_torch.ops.expressions import CompileError

        supervisor = getattr(self.app_context, "supervisor", None)
        if supervisor is not None:
            # the supervisor sees every processing error (it reacts to
            # cluster-peer failures only: resilience/supervisor.py)
            try:
                supervisor.notify_error(self, e)
            except Exception:  # noqa: BLE001 — supervision must not mask
                log.exception("supervisor notification failed")
        if isinstance(e, (FatalQueryError, CompileError)):
            # framework failures always surface to the sender; on an
            # @Async junction the raise unwinds the worker and the stored
            # error makes every later send re-raise
            self._fatal = e
            raise e
        if self.on_error_action == "STREAM" and self.fault_junction is not None:
            self.route_fault_events(events, e)
        else:
            # default/LOG action: log and DROP — the reference's
            # StreamJunction never propagates processing errors back to
            # the sender
            log.error("error processing events in stream '%s': %s\n%s",
                      self.definition.id, e, traceback.format_exc())

    def route_fault_events(self, events: List[Event], e: Exception):
        """Publish ``events`` + error to the '!stream' fault junction: the
        stream's attributes and ``_error`` (reference
        FaultStreamEventConverter)."""
        self.fault_junction.send_events([
            Event(timestamp=ev.timestamp, data=list(ev.data) + [str(e)])
            for ev in events])
