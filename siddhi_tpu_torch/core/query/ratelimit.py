"""Output rate limiters (host side).

Counterpart of ``siddhi_tpu/core/query/ratelimit.py``, a copy with its
imports pointed at the port. Mirror of reference ``query/output/ratelimit/**`` (19 classes): pass-through,
first/last/all per N events, first/last/all per time period, and snapshot
emitters. Rate limiting operates on decoded output chunks between the
selector and the callbacks (``OutputRateLimiter.sendToCallBacks:64-108``).

Time-based limiters are driven by the app scheduler (wall clock in live
mode, event time in playback) — they register a periodic trigger.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from siddhi_tpu_torch.core.event import Event
from siddhi_tpu_torch.query_api.execution import (
    EventOutputRate,
    OutputRate,
    SnapshotOutputRate,
    TimeOutputRate,
)


class OutputRateLimiter:
    def __init__(self, send: Callable[[List[Event]], None]):
        self._send = send

    def process(self, events: List[Event]):
        raise NotImplementedError

    def start(self, scheduler=None):
        pass

    def stop(self):
        pass

    def reset(self):
        """Discard buffered/counted state (snapshot restore: pending
        outputs of the rolled-back timeline must not flush)."""


class PassThroughRateLimiter(OutputRateLimiter):
    """``PassThroughOutputRateLimiter`` — no limiting."""

    def process(self, events: List[Event]):
        if events:
            self._send(events)


class EventRateLimiter(OutputRateLimiter):
    """all/first/last every N events (reference
    ``ratelimit/event/{All,First,Last}PerEventOutputRateLimiter``)."""

    def __init__(self, send, value: int, kind: str):
        super().__init__(send)
        self.value = value
        self.kind = kind
        self._counter = 0
        self._pending: List[Event] = []

    def reset(self):
        self._counter = 0
        self._pending = []

    def process(self, events: List[Event]):
        out: List[Event] = []
        for ev in events:
            self._counter += 1
            if self.kind == "first":
                if self._counter == 1:
                    out.append(ev)
            elif self.kind == "last":
                self._pending = [ev]
            else:
                self._pending.append(ev)
            if self._counter == self.value:
                self._counter = 0
                if self.kind in ("all", "last"):
                    out.extend(self._pending)
                    self._pending = []
        if out:
            self._send(out)


class TimeRateLimiter(OutputRateLimiter):
    """all/first/last every T ms, flushed by a scheduler tick (reference
    ``ratelimit/time/*PerTimeOutputRateLimiter``)."""

    def __init__(self, send, value: int, kind: str):
        super().__init__(send)
        self.value = value
        self.kind = kind
        self._pending: List[Event] = []
        self._sent_first = False
        self._scheduler = None
        self._job = None

    def reset(self):
        self._pending = []
        self._sent_first = False

    def start(self, scheduler=None):
        self._scheduler = scheduler
        if scheduler is not None:
            self._job = scheduler.schedule_periodic(self.value, self._tick)

    def stop(self):
        if self._scheduler is not None and self._job is not None:
            self._scheduler.cancel(self._job)

    def _tick(self, _ts: int):
        if self.kind == "first":
            self._sent_first = False
            return
        if self._pending:
            out, self._pending = self._pending, []
            self._send(out)

    def process(self, events: List[Event]):
        if self.kind == "first":
            if not self._sent_first and events:
                self._sent_first = True
                self._send(events[:1])
        elif self.kind == "last":
            if events:
                self._pending = [events[-1]]
        else:
            self._pending.extend(events)


class SnapshotRateLimiter(OutputRateLimiter):
    """``output snapshot every T``: re-emit the last-known OUTPUT STATE each
    period. Variant dispatch mirrors
    ``WrappedSnapshotOutputRateLimiter.java:75-116`` via (windowed,
    group_by, aggregated-output positions):

    - not windowed:            last event / last per group
      (``PerSnapshotOutputRateLimiter``, ``GroupByPerSnapshot...``)
    - windowed, no agg:        the window's current contents — CURRENT adds,
      EXPIRED removes the first data-equal entry
      (``WindowedPerSnapshotOutputRateLimiter``)
    - windowed, ALL agg, !gb:  last aggregate row, cleared by its expiry
      (``AllAggregationPerSnapshotOutputRateLimiter``)
    - windowed, some agg:      window contents with aggregate positions
      patched to the latest aggregate values [per group]
      (``Aggregation[GroupBy]WindowedPerSnapshotOutputRateLimiter``)
    - windowed, ALL agg, gb:   per-group last row with a live count; a group
      whose count hits zero stops emitting
      (``AllAggregationGroupByWindowedPerSnapshot...`` LastEventHolder)
    """

    def __init__(self, send, value: int, *, windowed: bool, key_fn=None,
                 agg_positions=(), out_size: int = 0, empty_send=None):
        super().__init__(send)
        self.value = value
        self.windowed = windowed
        self._empty_send = empty_send
        self.key_fn = key_fn
        self.agg_positions = tuple(agg_positions)
        self.all_agg = bool(self.agg_positions) and len(self.agg_positions) == out_size
        self._scheduler = None
        self._job = None
        # per-variant state
        self._last: Optional[Event] = None            # per-snapshot / all-agg
        self._group_last: dict = {}                   # group -> Event
        self._group_count: dict = {}                  # group -> live count (all-agg gb)
        self._events: list = []                       # windowed contents
        self._agg_values: dict = {}                   # position -> latest value
        self._group_agg: dict = {}                    # group -> {position: value}

    def reset(self):
        self._last = None
        self._group_last.clear()
        self._group_count.clear()
        self._events.clear()
        self._agg_values.clear()
        self._group_agg.clear()

    def start(self, scheduler=None):
        self._scheduler = scheduler
        if scheduler is not None:
            self._job = scheduler.schedule_periodic(self.value, self._tick)

    def stop(self):
        if self._scheduler is not None and self._job is not None:
            self._scheduler.cancel(self._job)

    @staticmethod
    def _copy(ev: Event) -> Event:
        return Event(timestamp=ev.timestamp, data=list(ev.data),
                     is_expired=ev.is_expired, pk=ev.pk)

    def _tick(self, _ts: int):
        out: List[Event] = []
        if not self.windowed:
            if self.key_fn is not None:
                out = [self._copy(e) for e in self._group_last.values()]
            elif self._last is not None:
                out = [self._copy(self._last)]
        elif self.all_agg and self.key_fn is None:
            if self._last is not None:
                out = [self._copy(self._last)]
        elif self.all_agg:
            # LastEventHolder.checkAndClearLastInEvent: drop zero-count groups
            for k in [k for k, c in self._group_count.items() if c <= 0]:
                self._group_last.pop(k, None)
                self._group_count.pop(k, None)
            out = [self._copy(e) for e in self._group_last.values()]
        elif self.agg_positions:
            seen_groups = set()
            for ev in self._events:
                if self.key_fn is not None:
                    # ONE row per group, first occurrence wins
                    # (AggregationGroupByWindowed...constructOutputChunk's
                    # outputGroupingKeys dedup)
                    k = self.key_fn(ev)
                    if k in seen_groups:
                        continue
                    seen_groups.add(k)
                    vals = self._group_agg.get(k, {})
                else:
                    vals = self._agg_values
                c = self._copy(ev)
                for p in self.agg_positions:
                    c.data[p] = vals.get(p)
                out.append(c)
        else:
            out = [self._copy(e) for e in self._events]
        if out:
            self._send(out)
        elif self._empty_send is not None:
            self._empty_send()

    def _remove_matching(self, ev: Event) -> bool:
        # aggregate positions are EXCLUDED from the expiry match (their
        # values advance between insert and expiry) — the snapshot
        # comparators skip them (AggregationWindowedPerSnapshot...java:58-80)
        skip = set(self.agg_positions)
        key = [v for i, v in enumerate(ev.data) if i not in skip]
        for i, held in enumerate(self._events):
            if [v for j, v in enumerate(held.data) if j not in skip] == key:
                del self._events[i]
                return True
        return False

    def process(self, events: List[Event]):
        for ev in events:
            if not self.windowed:
                if not ev.is_expired:
                    if self.key_fn is not None:
                        self._group_last[self.key_fn(ev)] = ev
                    else:
                        self._last = ev
            elif self.all_agg and self.key_fn is None:
                # expireds CLEAR the held aggregate (AllAggregationPer
                # SnapshotOutputRateLimiter.java process else-branch)
                self._last = ev if not ev.is_expired else None
            elif self.all_agg:
                k = self.key_fn(ev)
                self._group_last[k] = ev
                self._group_count[k] = (self._group_count.get(k, 0)
                                        + (1 if not ev.is_expired else -1))
            elif self.agg_positions:
                vals = (self._group_agg.setdefault(self.key_fn(ev), {})
                        if self.key_fn is not None else self._agg_values)
                if not ev.is_expired:
                    self._events.append(ev)
                    for p in self.agg_positions:
                        vals[p] = ev.data[p]
                elif self._remove_matching(ev):
                    # agg values advance only when the expiry matched a held
                    # row (AggregationWindowedPerSnapshot...java:96-104)
                    for p in self.agg_positions:
                        vals[p] = ev.data[p]
            else:
                if not ev.is_expired:
                    self._events.append(ev)
                else:
                    self._remove_matching(ev)


class GroupEventRateLimiter(OutputRateLimiter):
    """first/last every N events PER GROUP (reference
    ``ratelimit/event/{First,Last}GroupByPerEventOutputRateLimiter`` —
    chosen automatically when the query has a group-by, like
    ``OutputParser.java`` does)."""

    def __init__(self, send, value: int, kind: str, key_fn):
        super().__init__(send)
        self.value = value
        self.kind = kind
        self.key_fn = key_fn
        self._counter = 0
        self._group_counts: dict = {}
        self._last: dict = {}

    def reset(self):
        self._counter = 0
        self._group_counts.clear()
        self._last.clear()

    def process(self, events: List[Event]):
        out: List[Event] = []
        for ev in events:
            k = self.key_fn(ev)
            if self.kind == "first":
                # per-group counter: emit the group's 1st event, swallow its
                # next value-1, then re-arm (FirstGroupByPerEventOutput
                # RateLimiter.java:58-68 — entry removed at count value-1)
                count = self._group_counts.get(k)
                if count is None:
                    self._group_counts[k] = 1
                    out.append(ev)
                elif count == self.value - 1:
                    del self._group_counts[k]
                else:
                    self._group_counts[k] = count + 1
            else:  # last: GLOBAL counter over last-per-group insertion-order
                # map (LastGroupByPerEventOutputRateLimiter.java:63-72)
                self._counter += 1
                self._last[k] = ev
                if self._counter == self.value:
                    self._counter = 0
                    out.extend(self._last.values())
                    self._last.clear()
        if out:
            self._send(out)


class GroupTimeRateLimiter(OutputRateLimiter):
    """first/last every T ms per group (reference
    ``ratelimit/time/{First,Last}GroupByPerTimeOutputRateLimiter``)."""

    def __init__(self, send, value: int, kind: str, key_fn):
        super().__init__(send)
        self.value = value
        self.kind = kind
        self.key_fn = key_fn
        self._first_seen: set = set()
        self._last: dict = {}
        self._scheduler = None
        self._job = None

    def reset(self):
        self._first_seen.clear()
        self._last.clear()

    def start(self, scheduler=None):
        self._scheduler = scheduler
        if scheduler is not None:
            self._job = scheduler.schedule_periodic(self.value, self._tick)

    def stop(self):
        if self._scheduler is not None and self._job is not None:
            self._scheduler.cancel(self._job)

    def _tick(self, _ts: int):
        if self.kind == "first":
            self._first_seen.clear()
            return
        if self._last:
            out = list(self._last.values())
            self._last.clear()
            self._send(out)

    def process(self, events: List[Event]):
        out: List[Event] = []
        for ev in events:
            k = self.key_fn(ev)
            if self.kind == "first":
                if k not in self._first_seen:
                    self._first_seen.add(k)
                    out.append(ev)
            else:
                self._last[k] = ev
        if out:
            self._send(out)


class PartitionedRateLimiter(OutputRateLimiter):
    """One limiter instance PER PARTITION KEY: the reference clones the
    whole query runtime — including its OutputRateLimiter — per key
    (PartitionInstanceRuntime), so counters/windows never mix across
    keys. Events route by ``Event.pk``."""

    def __init__(self, send, factory):
        super().__init__(send)
        self._factory = factory
        self._per_key: dict = {}
        self._scheduler = None

    def _limiter(self, pk):
        lim = self._per_key.get(pk)
        if lim is None:
            lim = self._per_key[pk] = self._factory()
            lim.start(self._scheduler)
        return lim

    def process(self, events: List[Event]):
        by: dict = {}
        for ev in events:
            by.setdefault(ev.pk, []).append(ev)
        for pk, evs in by.items():
            self._limiter(pk).process(evs)

    def start(self, scheduler=None):
        self._scheduler = scheduler
        for lim in self._per_key.values():
            lim.start(scheduler)

    def stop(self):
        for lim in self._per_key.values():
            lim.stop()

    def reset(self):
        for lim in self._per_key.values():
            lim.stop()
        self._per_key.clear()

    def reset_keys(self, ids):
        """Drop retired partition keys' limiter instances (@purge) so a
        recycled pk starts fresh and periodic jobs don't leak."""
        for pk in ids:
            lim = self._per_key.pop(int(pk), None)
            if lim is not None:
                lim.stop()


def rate_uses_group_key(rate: Optional[OutputRate], windowed: bool,
                        agg_positions) -> bool:
    """Does the limiter variant for ``rate`` key on the group? first/last
    event/time limiters do; snapshot does unless it is the windowed no-agg
    variant (the wrapper picks WindowedPerSnapshot there, which unwraps
    GroupedComplexEvents). The single source of truth for callers deciding
    whether to attach a group key to output events."""
    if isinstance(rate, (EventOutputRate, TimeOutputRate)):
        return rate.type in ("first", "last")
    if isinstance(rate, SnapshotOutputRate):
        return not windowed or bool(agg_positions)
    return False


def create_rate_limiter(rate: Optional[OutputRate], send,
                        group_key_fn=None,
                        partitioned: bool = False,
                        windowed: bool = False,
                        agg_positions=(),
                        out_size: int = 0,
                        empty_send=None) -> OutputRateLimiter:
    """``group_key_fn`` (group tuple from an output Event) switches
    first/last limiters to their per-group variants, exactly as the
    reference OutputParser picks GroupBy classes for grouped queries.
    ``partitioned`` wraps the limiter per partition key (events carry
    ``pk``), matching the reference's per-key query instances.
    ``windowed``/``agg_positions``/``out_size`` select the snapshot
    variant (WrappedSnapshotOutputRateLimiter.java:75-116)."""
    if rate is None:
        return PassThroughRateLimiter(send)

    def build():
        if isinstance(rate, EventOutputRate):
            if group_key_fn is not None and rate.type in ("first", "last"):
                return GroupEventRateLimiter(send, rate.value, rate.type,
                                             group_key_fn)
            return EventRateLimiter(send, rate.value, rate.type)
        if isinstance(rate, TimeOutputRate):
            if group_key_fn is not None and rate.type in ("first", "last"):
                return GroupTimeRateLimiter(send, rate.value, rate.type,
                                            group_key_fn)
            return TimeRateLimiter(send, rate.value, rate.type)
        if isinstance(rate, SnapshotOutputRate):
            key_fn = (group_key_fn
                      if rate_uses_group_key(rate, windowed, agg_positions)
                      else None)
            return SnapshotRateLimiter(send, rate.value, windowed=windowed,
                                       key_fn=key_fn,
                                       agg_positions=agg_positions,
                                       out_size=out_size,
                                       empty_send=empty_send)
        raise NotImplementedError(f"rate {rate!r}")

    if partitioned:
        return PartitionedRateLimiter(send, build)
    return build()
