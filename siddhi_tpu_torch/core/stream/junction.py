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

The reference's overload quotas, ingest WAL, journey tracing, telemetry
gauges and supervisor hooks are not ported yet (ROADMAP A.10).
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
import traceback
from typing import List, Optional

from siddhi_tpu_torch.core.event import Event, HostBatch, LazyColumns
from siddhi_tpu_torch.query_api.definitions import StreamDefinition

log = logging.getLogger(__name__)

# marker for "no unit in flight" (None is the queue's stop sentinel)
_NOTHING = object()

# the junction whose delivery loop runs on THIS thread: receivers reached
# through the Event path (Receiver.receive has no junction parameter)
# read it so their pipelined completions know their delivering junction
_DELIVERING = threading.local()

# the worker polls its queue with this bound, so an idle worker drains
# the pipeline within one poll
_IDLE_POLL_S = 0.1
# a producer blocked on a full @Async queue re-checks the worker's fatal
# error every slice and logs every timeout (the reference's values)
_BLOCK_PUT_SLICE_S = 0.25
_BLOCK_TIMEOUT_S = 5.0


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


class StreamJunction:
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
        self._adapt_lock = threading.Lock()
        self._cur_batch = 256
        self._lat_ewma = 0.0
        self._running = False
        self._fatal: Optional[Exception] = None
        # the unit the worker is delivering, kept for a replacement worker
        # (restart_worker); the generation retires a superseded worker
        self._inflight = _NOTHING
        self._inflight_owner: Optional[threading.Thread] = None
        self._gen = 0

    def subscribe(self, receiver: Receiver):
        if receiver not in self.receivers:
            self.receivers.append(receiver)

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

    def send_events(self, events: List[Event]):
        if not events:
            return
        if self._fatal is not None:
            # the async worker died on a framework failure: surface it to
            # the producer instead of blocking on a queue nobody drains
            raise self._fatal
        if self._async and self._running:
            self._enqueue(events)
        else:
            self._deliver(events)
            # synchronous sends keep synchronous semantics: batches the
            # receivers pipelined drain before the send returns
            self._flush_pipeline(own_only=True)

    def send_batch(self, batch):
        """Columnar publish (no Event objects), delivered as one unit;
        @Async junctions enqueue it behind pending event chunks."""
        if self._fatal is not None:
            raise self._fatal
        if self._async and self._running:
            self._enqueue(batch)
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

    def _enqueue(self, item):
        """Producer side of @Async: a bounded wait on a full queue that
        re-checks the worker's fatal error each slice, so a worker dying
        mid-wait cannot park the producer forever."""
        try:
            self._queue.put_nowait(item)
            return
        except queue.Full:
            pass
        waited = 0.0
        while True:
            try:
                self._queue.put(item, timeout=_BLOCK_PUT_SLICE_S)
                return
            except queue.Full:
                pass
            if self._fatal is not None:
                raise self._fatal
            waited += _BLOCK_PUT_SLICE_S
            if waited >= _BLOCK_TIMEOUT_S:
                waited = 0.0
                log.warning(
                    "producer blocked on full @Async queue of stream '%s': "
                    "the worker is not draining", self.definition.id)

    # ---------------------------------------------------------- delivery

    def _deliver(self, events: List[Event]):
        prev = current_delivering_junction()
        _DELIVERING.junction = self
        try:
            for r in self.receivers:
                try:
                    r.receive(events)
                except Exception as e:  # noqa: BLE001 — per-event fault routing
                    self.handle_error(events, e)
        finally:
            _DELIVERING.junction = prev

    def _deliver_batch(self, batch):
        prev = current_delivering_junction()
        _DELIVERING.junction = self
        try:
            for r in self.receivers:
                # receivers mutate batch.cols in place (filters, key
                # columns): each gets its own dict; LazyColumns keeps
                # device-held outputs unpulled until read
                try:
                    r.receive_batch(HostBatch(LazyColumns(batch.cols),
                                              size=batch._size), self)
                except Exception as e:  # noqa: BLE001 — per-event fault routing
                    self.handle_error(self.decode_events(batch), e)
        finally:
            _DELIVERING.junction = prev

    def record_completion(self, elapsed_ms: float):
        """The deliver->emit time of a pipelined batch, from the pump at
        drain: the worker's own timing saw only the dispatch."""
        self._adapt(elapsed_ms)

    def _adapt(self, elapsed_ms: float):
        """latency.target control loop: average the delivery latency,
        halve the cap on overshoot, regrow it under half the target."""
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

    def _timed(self, deliver, unit):
        """Deliver one unit and feed its latency to the control loop,
        unless it pipelined (its dispatch returned at once;
        ``record_completion`` supplies the true sample at drain)."""
        t0 = time.perf_counter()
        n0 = self._pump_submits()
        deliver(unit)
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
            if gen != self._gen:
                return     # superseded by restart_worker
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
                self._timed(self._deliver_batch, item)
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
                    continue
                if more is None:
                    stop_after = True
                    break
                if not isinstance(more, list):
                    follow = more
                    break
                batch.extend(more)
            if gen != self._gen and follow is None and not stop_after:
                return   # superseded while coalescing: the unit stays parked
            self._timed(self._deliver, batch)
            if follow is not None:
                self._inflight = follow
                self._timed(self._deliver_batch, follow)
            self._inflight = _NOTHING
            if stop_after or self._queue.empty():
                self._flush_pipeline()
            if stop_after:
                return

    # ------------------------------------------------------------ errors

    def handle_error(self, events: List[Event], e: Exception):
        from siddhi_tpu_torch.ops.expressions import CompileError

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
