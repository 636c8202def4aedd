"""Host scheduler: TIMER injection for time-based windows and rate limiters.

Counterpart of ``siddhi_tpu/core/util/scheduler.py`` (reference
``util/Scheduler.java:48-171``): stages request a wake time
(``notify_at``); in live mode a wall-clock ``threading.Timer`` fires, in
playback mode (``@app:playback``) the event-time clock drives firing from
a heap. Fired targets receive the timestamp and inject a TIMER chunk into
their query (``QueryRuntime.process_timer``).

Playback order: ``InputHandler.send`` sets the clock before publishing to
the junction, and the time-change listener fires every due timer inside
``set_current_timestamp``, so timers at or before the new event time run
as their own chunks ahead of the event.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Tuple


class Scheduler:
    def __init__(self, app_context):
        self.app_context = app_context
        self._lock = threading.RLock()
        self._heap: List[Tuple[int, int, Callable]] = []
        self._counter = itertools.count()
        self._scheduled: Dict[Tuple[int, int], bool] = {}
        self._live_timers: List[threading.Timer] = []
        self._periodic: List["_PeriodicJob"] = []
        self._stopped = False
        if app_context.playback:
            app_context.timestamp_generator.add_time_change_listener(self._on_time_change)

    # ------------------------------------------------------------- notify

    def notify_at(self, ts: int, target: Callable[[int], None]):
        """Request `target(ts)` to run at event/wall time `ts` (deduped)."""
        key = (id(target), int(ts))
        with self._lock:
            if self._stopped or key in self._scheduled:
                return
            self._scheduled[key] = True
            if self.app_context.playback:
                heapq.heappush(self._heap, (int(ts), next(self._counter), target))
                return
        # live mode: wall-clock timer
        delay = max(0.0, (ts - self.app_context.timestamp_generator.current_time()) / 1000.0)
        timer = threading.Timer(delay, self._fire_live)
        # the timer removes itself once it fires (the reference keeps every
        # fired timer in the list, which then grows without bound)
        timer.args = (ts, target, key, timer)
        timer.daemon = True
        with self._lock:
            self._live_timers.append(timer)
        timer.start()

    def next_due_except(self, target):
        """The earliest pending playback time of any target but ``target``
        (None if there is none): how far a TIMER step of ``target`` may
        sweep before another timer must run first."""
        with self._lock:
            times = [ts for ts, _seq, tg in self._heap if tg is not target]
        return min(times) if times else None

    def _fire_live(self, ts: int, target, key, timer):
        with self._lock:
            try:
                self._live_timers.remove(timer)
            except ValueError:
                pass          # clear_pending already dropped it
            if self._stopped:
                return
            self._scheduled.pop(key, None)
        # the target may still run after a shutdown that began once the
        # check above passed: each timer target checks app_context.stopped
        # under its query's lock before it steps
        target(ts)

    def _on_time_change(self, new_ts: int):
        while True:
            with self._lock:
                if not self._heap or self._heap[0][0] > new_ts:
                    return
                ts, _seq, target = heapq.heappop(self._heap)
                self._scheduled.pop((id(target), ts), None)
            target(ts)

    # ----------------------------------------------------------- periodic

    def schedule_periodic(self, interval_ms: int, callback: Callable[[int], None]):
        """Recurring tick every interval (used by time-based rate limiters
        and periodic triggers)."""
        job = _PeriodicJob(self, interval_ms, callback)
        with self._lock:
            self._periodic.append(job)
        job.arm()
        return job

    def cancel(self, job):
        job.cancelled = True
        if getattr(job, "_anchor_cancel", None) is not None:
            job._anchor_cancel()
            job._anchor_cancel = None

    def clear_pending(self):
        """Drop every pending timer of the abandoned timeline (snapshot
        restore): one-shots are re-requested by the restored stages, and
        periodic jobs (triggers, time rate limiters) are re-armed HERE at
        the restored clock — after a rollback their old heap entries
        would sit in the future of the replayed window and never fire."""
        with self._lock:
            self._heap.clear()
            self._scheduled.clear()
            for t in self._live_timers:
                t.cancel()
            self._live_timers.clear()
            jobs = [j for j in self._periodic if not j.cancelled]
        for j in jobs:
            j.arm()

    def shutdown(self):
        with self._lock:
            self._stopped = True
            for t in self._live_timers:
                t.cancel()
            self._live_timers.clear()
            self._heap.clear()
            self._scheduled.clear()


class _PeriodicJob:
    def __init__(self, scheduler: Scheduler, interval_ms: int, callback):
        self.scheduler = scheduler
        self.interval_ms = interval_ms
        self.callback = callback
        self.cancelled = False

    _anchor_cancel = None

    def arm(self):
        ctx = self.scheduler.app_context
        if self._anchor_cancel is not None:
            # re-arm (snapshot-restore clear_pending): a stale first-event
            # anchor would start a second interleaved periodic chain
            self._anchor_cancel()
            self._anchor_cancel = None
        if ctx.playback and ctx.timestamp_generator._last_event_ts < 0:
            def _anchor(first_ts: int):
                self._anchor_cancel = None
                if self.cancelled:
                    return
                self.next_ts = first_ts + self.interval_ms
                self.scheduler.notify_at(self.next_ts, self._tick)

            self._anchor_cancel = ctx.timestamp_generator.once_first_time(_anchor)
            return
        now = ctx.timestamp_generator.current_time()
        self.next_ts = now + self.interval_ms
        self.scheduler.notify_at(self.next_ts, self._tick)

    def _tick(self, ts: int):
        if self.cancelled:
            return
        self.callback(ts)
        if not self.cancelled:
            self.next_ts = ts + self.interval_ms
            self.scheduler.notify_at(self.next_ts, self._tick)
