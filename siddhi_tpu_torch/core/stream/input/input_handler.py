"""InputHandler / InputManager: API entry for pushing events.

Counterpart of ``siddhi_tpu/core/stream/input/input_handler.py``: ``send``
variants set the app clock and forward into the junction; ``send_columns``
is the columnar bulk path, packed on the app's ingest pool when it has one
(``siddhi_tpu.ingest_pool``). The first send starts the app. The quiesce
gate is a host-side RLock. Inside it, before the clock moves, a send is
checked against ``@app:enforceOrder`` (each stream's watermark and the
batch's own order), then recorded in the ingest WAL when the app has one
(``resilience/replay.py``); a WAL replay bypasses the watermark.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from siddhi_tpu_torch.core.event import Event, HostBatch, pack_pool_of
from siddhi_tpu_torch.core.stream.junction import StreamJunction
from siddhi_tpu_torch.query_api.definitions import AttrType


class InputHandler:
    def __init__(self, stream_id: str, junction: StreamJunction, app_context,
                 barrier: threading.RLock, ensure_started=None):
        self.stream_id = stream_id
        self.junction = junction
        self.app_context = app_context
        self._barrier = barrier
        self._ensure_started = ensure_started
        self._last_ts = None   # @app:enforceOrder watermark

    def _check_order(self, first_ts: int, last_ts: int):
        """@app:enforceOrder: a send whose first timestamp precedes the
        stream's watermark raises instead of reordering window and pattern
        state."""
        if self._last_ts is not None and first_ts < self._last_ts:
            raise ValueError(
                f"@app:enforceOrder: event timestamp {first_ts} precedes "
                f"stream '{self.stream_id}' watermark {self._last_ts}")
        self._last_ts = last_ts if self._last_ts is None \
            else max(self._last_ts, last_ts)

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
        wal = self.app_context.ingest_wal
        replaying = wal is not None and wal.in_replay()
        with self._barrier:
            # the order check sits inside the barrier (atomic with delivery
            # order) and before the clock moves: a refused batch fires no
            # timers. A WAL replay re-enters with its original timestamps,
            # behind the watermark
            if self.app_context.enforce_order and events and not replaying:
                ts_seq = [e.timestamp for e in events]
                if any(b < a for a, b in zip(ts_seq, ts_seq[1:])):
                    raise ValueError(
                        f"@app:enforceOrder: non-monotone timestamps inside "
                        f"a batch on stream '{self.stream_id}'")
                self._check_order(ts_seq[0], ts_seq[-1])
            # accepted: recorded before delivery, inside the barrier, so a
            # checkpoint always cuts between batches. The record's sequence
            # number rides to the junction: if overload admission sheds the
            # batch (resilience/overload.py) the record is discarded, and a
            # replay covers exactly the suffix that was not shed
            wal_seq = None
            if wal is not None:
                wal_seq = wal.record_events(self.stream_id, events)
            for ev in events:
                tsg.set_current_timestamp(ev.timestamp)
            self.junction.send_events(events, wal_seq=wal_seq)

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
        now = tsg.current_time()
        batch = HostBatch.from_columns(
            data, self.junction.definition, self.app_context.string_dictionary,
            timestamps=timestamps, default_ts=now,
            pool=pack_pool_of(self.app_context))
        wal = self.app_context.ingest_wal
        replaying = wal is not None and wal.in_replay()
        with self._barrier:
            if timestamps is not None:
                ts_arr = np.asarray(timestamps, np.int64)
                if ts_arr.size:
                    # the order check before the clock moves (see send)
                    if self.app_context.enforce_order and not replaying:
                        if np.any(ts_arr[1:] < ts_arr[:-1]):
                            raise ValueError(
                                f"@app:enforceOrder: non-monotone timestamps "
                                f"inside a batch on stream '{self.stream_id}'")
                        self._check_order(int(ts_arr[0]), int(ts_arr[-1]))
                    tsg.set_current_timestamp(int(ts_arr.min()))
                    tsg.set_current_timestamp(int(ts_arr.max()))
            wal_seq = None
            if wal is not None:
                # the raw columns, copied (a replay re-encodes them against
                # the restored dictionary), with the timestamps resolved: a
                # default-stamped batch replays at its ingest time
                wal_seq = wal.record_columns(
                    self.stream_id, self._replayable(data),
                    timestamps if timestamps is not None
                    else np.full(int(batch.size), now, np.int64))
            self.junction.send_batch(batch, wal_seq=wal_seq)


    def _replayable(self, data):
        """The columns as a WAL replay must see them: a string attribute
        sent as dictionary ids (a decoded wire frame) is recorded as its
        strings. A restore rolls the dictionary back to the revision, so
        ids of strings first seen after it would dangle; strings re-encode
        in arrival order, to the ids they had. (The reference records the
        ids and replays them dangling.)"""
        out = None
        dic = self.app_context.string_dictionary
        for attr in self.junction.definition.attributes:
            col = data.get(attr.name)
            if attr.type != AttrType.STRING or col is None:
                continue
            col = np.asarray(col)
            if not np.issubdtype(col.dtype, np.integer):
                continue
            uniq, inv = np.unique(col, return_inverse=True)
            strings = np.array([dic.decode(int(i)) for i in uniq], dtype=object)
            out = dict(data) if out is None else out
            out[attr.name] = strings[inv.reshape(col.shape)]
        return data if out is None else out


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
