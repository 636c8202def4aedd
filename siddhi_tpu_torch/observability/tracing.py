"""Structured tracing spans with Chrome-trace export.

Counterpart of ``siddhi_tpu/observability/tracing.py`` (no device code:
the same tracer). A span covers one host-side stage of the pipeline
(compile, plan, jit, junction dispatch, query step, sink publish,
persist) at batch granularity — the host-side complement of the device
profiler trace (``SiddhiAppRuntime.start_trace``,
``observability/device_trace.py``), which sees the card's kernels but
not the host pipeline between them.

Design constraints, in priority order:

1. **Near-zero cost when disabled.** ``span(...)`` checks one module
   flag and returns a shared no-op context manager — no allocation
   beyond the kwargs dict, no locks. The hot path (junction dispatch,
   query step) runs it per *batch*, not per event.
2. **Thread-safe when enabled.** Spans finish in LIFO order per thread
   (context managers), so nesting is correct by construction; the ring
   buffer is a ``deque(maxlen=...)`` whose appends are atomic under the
   GIL. When full, the OLDEST span falls off (``dropped`` counts them) —
   tracing never grows without bound and never blocks.
3. **Standard output.** ``to_chrome_trace()`` emits the Trace Event
   Format (complete events, ``ph: "X"`` with pid/tid/ts/dur/name/args)
   that ``chrome://tracing`` and Perfetto load directly.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

_DEFAULT_CAPACITY = 65_536


class _FinishedSpan:
    __slots__ = ("name", "tid", "ts_us", "dur_us", "args")

    def __init__(self, name, tid, ts_us, dur_us, args):
        self.name = name
        self.tid = tid
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.args = args


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._tracer._record(self.name, self._t0, t1, self.args)
        return False


class Tracer:
    """Ring-buffered span collector (one per process — see ``TRACER``)."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.enabled = False
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        # guards buffer swaps and export snapshots against concurrent
        # producer appends ("deque mutated during iteration"); producers
        # hold it only for one append, so contention is one span long
        self._lock = threading.Lock()
        self.dropped = 0
        self._epoch_ns = time.perf_counter_ns()

    # ------------------------------------------------------------ control

    def start(self, capacity: Optional[int] = None) -> None:
        """Enable collection into a fresh ring buffer."""
        with self._lock:
            if capacity is not None:
                self.capacity = int(capacity)
            self._buf = deque(maxlen=self.capacity)
            self.dropped = 0
            self._epoch_ns = time.perf_counter_ns()
            self.enabled = True

    def stop(self) -> dict:
        """Disable collection and return the Chrome-trace JSON object."""
        self.enabled = False
        return self.to_chrome_trace()

    def clear(self) -> None:
        with self._lock:
            self._buf = deque(maxlen=self.capacity)
            self.dropped = 0

    def __len__(self) -> int:
        return len(self._buf)

    # ---------------------------------------------------------- recording

    def span(self, name: str, **args):
        if not self.enabled:
            return _NOOP
        return _Span(self, name, args)

    def _record(self, name: str, t0_ns: int, t1_ns: int, args: dict):
        if not self.enabled:
            return     # stopped while the span was open
        span_rec = _FinishedSpan(
            name, threading.get_ident(),
            (t0_ns - self._epoch_ns) / 1000.0,
            max(t1_ns - t0_ns, 1) / 1000.0,
            args)
        with self._lock:
            if not self.enabled:
                return   # a racing stop() export must not see new appends
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1     # deque evicts the oldest on append
            self._buf.append(span_rec)

    # ------------------------------------------------------------- export

    def to_chrome_trace(self) -> dict:
        """Trace Event Format: complete events sorted by (tid, ts) so
        parents precede children, plus process/thread metadata."""
        pid = os.getpid()
        with self._lock:   # snapshot against concurrent producer appends
            buf = list(self._buf)
            dropped = self.dropped
        spans = sorted(buf, key=lambda s: (s.tid, s.ts_us))
        events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "siddhi_tpu_torch"},
        }]
        for s in spans:
            ev = {
                "name": s.name,
                "cat": "siddhi",
                "ph": "X",
                "pid": pid,
                "tid": s.tid,
                "ts": round(s.ts_us, 3),
                "dur": round(s.dur_us, 3),
            }
            if s.args:
                ev["args"] = {k: _jsonable(v) for k, v in s.args.items()}
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": dropped},
        }


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# process-global tracer: spans from every app/runtime in this process
# land in one timeline (pid/tid separate them), controlled by
# POST /trace/start|stop on the REST service or Tracer.start()/stop()
TRACER = Tracer()


def span(name: str, **args):
    """``with span("jit", query="q1"): ...`` — records a structured span
    on the global tracer; a shared no-op when tracing is off."""
    if not TRACER.enabled:
        return _NOOP
    return _Span(TRACER, name, args)
