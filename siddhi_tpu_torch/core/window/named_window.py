"""Named windows: ``define window W (...) <window>(...)``.

Counterpart of ``siddhi_tpu/core/window/named_window.py``, the mirror of
reference ``core/window/Window.java:65``: one shared window instance;
queries ``insert into W`` feed it, queries ``from W`` receive its
emissions (CURRENT and/or EXPIRED, as the definition's ``output`` clause
says) through the window's output junction, and joins and on-demand
queries probe its held rows (``contents``). A device window keeps its
state on the app's device, updated in place; a host window (sort,
frequent, ...) runs on the host.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np
import torch

from siddhi_tpu_torch.core.event import CURRENT, EXPIRED, TIMER, Event, HostBatch, LazyColumns
from siddhi_tpu_torch.core.plan.resolvers import SingleStreamResolver
from siddhi_tpu_torch.core.plan.selector_plan import GK_KEY
from siddhi_tpu_torch.core.stream.junction import FatalQueryError, Receiver, StreamJunction
from siddhi_tpu_torch.core.table.in_memory_table import to_device
from siddhi_tpu_torch.ops.expressions import TYPE_KEY, VALID_KEY, TorchXP
from siddhi_tpu_torch.ops.windows import NOTIFY_KEY, OVERFLOW_KEY, FLUSH_KEY, conform_cols
from siddhi_tpu_torch.query_api.definitions import WindowDefinition


class NamedWindowRuntime(Receiver):
    def __init__(self, definition: WindowDefinition, app_context, dictionary):
        from siddhi_tpu_torch.ops.windows import create_window_stage

        self.definition = definition
        self.app_context = app_context
        self.dictionary = dictionary
        self.device = app_context.device
        self.stage = create_window_stage(
            definition.window, definition,
            SingleStreamResolver(definition, dictionary), app_context)
        self.host_mode = getattr(self.stage, "host_mode", False)
        self.state = None if self.host_mode else self.stage.init_state(1, self.device)
        self.out_junction = StreamJunction(definition, app_context)
        self.scheduler = None
        self._timer_cb = self.process_timer   # one target: the scheduler dedupes
        self._lock = threading.RLock()
        self._now_override = None   # a timer chunk runs at its scheduled time

    def contents(self):
        """The probe surface of joins and on-demand queries (reference
        WindowWindowProcessor.find)."""
        with self._lock:
            if self.host_mode:
                return self.stage.contents()
            return self.stage.contents(self.state)

    def receive(self, events: List[Event]):
        self._process(HostBatch.from_events(events, self.definition, self.dictionary))

    # a query `insert into W` has the window as its output junction
    send_events = receive

    def send_batch(self, batch: HostBatch):
        """The columnar re-publish of an inserting query."""
        cols = dict(LazyColumns(batch.cols))
        t = cols.get(TYPE_KEY)
        if isinstance(t, np.ndarray):
            # EXPIRED -> CURRENT on insert (InsertIntoStreamCallback)
            cols[TYPE_KEY] = np.where(t == EXPIRED, CURRENT, t).astype(np.int8)
        elif t is not None:
            cols[TYPE_KEY] = torch.where(t == EXPIRED, CURRENT, t)
        self._process(HostBatch(cols))

    def process_timer(self, ts: int):
        from siddhi_tpu_torch.core.query.runtime import _zero_value

        batch = HostBatch.from_events(
            [Event(timestamp=int(ts),
                   data=[_zero_value(a.type) for a in self.definition.attributes])],
            self.definition, self.dictionary)
        batch.cols[TYPE_KEY][...] = TIMER
        # the lock comes before the override (see QueryRuntime.process_timer)
        with self._lock:
            self._now_override = int(ts)
            try:
                self._process(batch)
            finally:
                self._now_override = None

    def _process(self, batch: HostBatch):
        with self._lock:
            now = (self._now_override if self._now_override is not None
                   else int(self.app_context.timestamp_generator.current_time()))
            if self.host_mode:
                cols = {k: batch.cols[k] for k in list(batch.cols)}
                cols[GK_KEY] = np.zeros(cols[VALID_KEY].shape[0], np.int32)
                out_batch, notify = self.stage.process(HostBatch(cols), now)
                out = dict(out_batch.cols)
            else:
                cols = {k: to_device(v, self.device) for k, v in dict.items(batch.cols)}
                cols[GK_KEY] = torch.zeros(cols[VALID_KEY].shape[0], dtype=torch.int32,
                                           device=self.device)
                ctx = {"xp": TorchXP(self.device), "current_time": now}
                _st, out = self.stage.apply(self.state, conform_cols(self.stage, cols), ctx)
                out = LazyColumns(out)
                overflow = out.pop(OVERFLOW_KEY, None)
                if overflow is not None and int(overflow) > 0:
                    raise FatalQueryError(
                        f"window '{self.definition.id}': buffer capacity exceeded "
                        f"— raise siddhi_tpu.window_capacity before creating "
                        f"the runtime")
                notify = out.pop(NOTIFY_KEY, None)
            out.pop(FLUSH_KEY, None)
            wanted = {"current": (CURRENT,), "expired": (EXPIRED,),
                      "all": (CURRENT, EXPIRED)}[self.definition.output_event_type]
            types = np.asarray(out[TYPE_KEY])
            hb = HostBatch({**{k: out[k] for k in list(out)},
                            VALID_KEY: np.asarray(out[VALID_KEY]) & np.isin(types, wanted)})
            events = hb.to_events(
                [(a.name, a.type) for a in self.definition.attributes], self.dictionary)
        if events:
            self.out_junction.send_events(events)
        if notify is not None and int(notify) >= 0 and self.scheduler is not None:
            self.scheduler.notify_at(int(notify), self._timer_cb)
