"""InputHandler / InputManager: API entry for pushing events.

Counterpart of ``siddhi_tpu/core/stream/input/input_handler.py``: ``send``
variants set the app clock and forward into the junction; ``send_columns``
is the columnar bulk path, packed on the app's ingest pool when it has one
(``siddhi_tpu.ingest_pool``). The first send starts the app. The quiesce
gate is a host-side RLock.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from siddhi_tpu_torch.core.event import Event, HostBatch, pack_pool_of
from siddhi_tpu_torch.core.stream.junction import StreamJunction


class InputHandler:
    def __init__(self, stream_id: str, junction: StreamJunction, app_context,
                 barrier: threading.RLock, ensure_started=None):
        self.stream_id = stream_id
        self.junction = junction
        self.app_context = app_context
        self._barrier = barrier
        self._ensure_started = ensure_started

    def send(self, *args):
        """send(data_list) | send(ts, data_list) | send(Event) | send([Event,...])"""
        if getattr(self.app_context, "stopped", False):
            raise RuntimeError(
                f"SiddhiApp '{self.app_context.name}' has been shut down — "
                f"cannot send to '{self.stream_id}'")
        if self._ensure_started is not None:
            self._ensure_started()
        tsg = self.app_context.timestamp_generator
        if len(args) == 1:
            a = args[0]
            if isinstance(a, Event):
                events = [a]
            elif isinstance(a, (list, tuple)) and a and isinstance(a[0], Event):
                events = list(a)
            else:
                events = [Event(timestamp=tsg.current_time(), data=list(a))]
        elif len(args) == 2 and isinstance(args[0], int):
            events = [Event(timestamp=args[0], data=list(args[1]))]
        else:
            raise TypeError(f"unsupported send arguments: {args!r}")
        for ev in events:
            if ev.timestamp < 0:
                ev.timestamp = tsg.current_time()
        with self._barrier:
            for ev in events:
                tsg.set_current_timestamp(ev.timestamp)
            self.junction.send_events(events)

    def send_columns(self, data, timestamps=None):
        """Columnar bulk ingestion: one numpy array per attribute (strings
        as str arrays or pre-encoded int ids), optional per-row
        timestamps. Skips Event objects entirely."""
        if getattr(self.app_context, "stopped", False):
            raise RuntimeError(
                f"SiddhiApp '{self.app_context.name}' has been shut down — "
                f"cannot send to '{self.stream_id}'")
        if self._ensure_started is not None:
            self._ensure_started()
        tsg = self.app_context.timestamp_generator
        batch = HostBatch.from_columns(
            data, self.junction.definition, self.app_context.string_dictionary,
            timestamps=timestamps, default_ts=tsg.current_time(),
            pool=pack_pool_of(self.app_context))
        with self._barrier:
            if timestamps is not None:
                ts_arr = np.asarray(timestamps, np.int64)
                if ts_arr.size:
                    tsg.set_current_timestamp(int(ts_arr.min()))
                    tsg.set_current_timestamp(int(ts_arr.max()))
            self.junction.send_batch(batch)


class InputManager:
    def __init__(self, app_context, junctions: Dict[str, StreamJunction],
                 barrier: threading.RLock):
        self.app_context = app_context
        self._junctions = junctions
        self._barrier = barrier
        self._handlers: Dict[str, InputHandler] = {}
        self.ensure_started = None  # set by SiddhiAppRuntime (lazy app start)

    def get_input_handler(self, stream_id: str) -> InputHandler:
        h = self._handlers.get(stream_id)
        if h is None:
            if stream_id not in self._junctions:
                raise KeyError(f"stream '{stream_id}' is not defined")
            h = InputHandler(stream_id, self._junctions[stream_id], self.app_context,
                             self._barrier, ensure_started=self._start)
            self._handlers[stream_id] = h
        return h

    def _start(self):
        if self.ensure_started is not None:
            self.ensure_started()
