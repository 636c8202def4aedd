"""The traced run's record, and the reductions every metric reader shares.

A traced window holds, on one clock (the host's, in microseconds):

- ``spans``: the program's host spans (``observability/tracing.py``:
  ``junction.dispatch``, ``query.step``, ...) and the benchmark's own:
  ``bench.send`` around each send, ``bench.encode`` around the batch's
  encode and ``bench.drain`` around the dispatch pipeline's drain, as
  ``(name, tid, start, end, args)``;
- ``device``: every operation the profiler saw on the card (kernels,
  copies, sets) as ``(name, start, end)``, moved onto the host clock by a
  marker: one operation launched on the idle card inside a host span;
- ``before`` and ``after``: counters read at the window's ends;
- ``batches``: the sends timed in the window, ``rows`` the rows they sent
  to each input stream; ``window_s`` the window's length.
"""

from __future__ import annotations

import bisect
import heapq
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

MARK = "portbench.mark"
ENCODE_SPAN = "bench.encode"
DRAIN_SPAN = "bench.drain"
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class TraceRecord:
    config: dict
    device_kind: str
    batches: int
    rows: Dict[str, int]                    # input stream -> rows sent
    window: Tuple[float, float]             # host us
    spans: List[tuple] = field(default_factory=list)
    device: List[tuple] = field(default_factory=list)
    before: Dict[str, float] = field(default_factory=dict)
    after: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def delta(self, counter: str) -> Optional[float]:
        if counter not in self.after:
            return None
        return self.after[counter] - self.before.get(counter, 0.0)

    def self_us(self, parent: Callable, children: Callable) -> float:
        """Total time of the spans ``parent`` accepts, less the part that
        spans ``children`` accepts cover inside them on the same thread."""
        by_tid: Dict[int, list] = {}
        for s in self.spans:
            if children(s):
                by_tid.setdefault(s[1], []).append(s)
        starts = {}
        for tid, cs in by_tid.items():
            cs.sort(key=lambda c: c[2])
            starts[tid] = [c[2] for c in cs]
        total = 0.0
        for p in self.spans:
            if not parent(p):
                continue
            cs = by_tid.get(p[1], ())
            inner = []
            if cs:
                st = starts[p[1]]
                lo, hi = bisect.bisect_left(st, p[2]), bisect.bisect_right(st, p[3])
                inner = [(c[2], c[3]) for c in cs[lo:hi] if c is not p and c[3] <= p[3]]
            total += (p[3] - p[2]) - union_us(inner)
        return total

    def kernels(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(seconds, count) of the card's kernels whose name ``match``
        accepts, copies and sets left out."""
        sel = [d for d in self.device
               if not d[0].startswith(COPY_PREFIXES) and match(d[0])]
        return sum(d[2] - d[1] for d in sel) / 1e6, len(sel)

    def busy_s(self) -> float:
        lo, hi = self.window
        return union_us([(max(a, lo), min(b, hi)) for _n, a, b in self.device
                         if b > lo and a < hi]) / 1e6


def union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def stream_of(span) -> Optional[str]:
    return span[4].get("stream") if span[4] else None


class Tracing:
    """Host spans and the device profiler over one window."""

    def __init__(self, device):
        self.device = device
        self.prof = None

    def start(self):
        import torch

        from siddhi_tpu_torch.observability.tracing import TRACER

        self._wrap()
        TRACER.start(capacity=1 << 22)
        if self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            # the card's operations only: a host activity would record
            # every aten op of the window and take minutes to read back
            self._buf = torch.zeros(1, device=self.device)
            torch.cuda.synchronize(self.device)
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._mark()

    def _wrap(self):
        """Spans from the benchmark around two calls into the program whose
        layers hold no span of their own: the encode of a sent batch
        (``HostBatch.from_columns``) and the dispatch pipeline's drain
        (``CompletionPump._drain_owner``: the wait for the card's outputs,
        then the emit). Installed for the traced window only."""
        from siddhi_tpu_torch.core.event import HostBatch
        from siddhi_tpu_torch.core.query.completion import CompletionPump
        from siddhi_tpu_torch.observability.tracing import span

        self._orig = (HostBatch.__dict__["from_columns"], CompletionPump._drain_owner)
        encode, drain = self._orig[0].__func__, self._orig[1]

        def from_columns(*args, **kwargs):
            with span(ENCODE_SPAN):
                return encode(*args, **kwargs)

        def _drain_owner(pump, *args, **kwargs):
            with span(DRAIN_SPAN):
                return drain(pump, *args, **kwargs)

        HostBatch.from_columns = staticmethod(from_columns)
        CompletionPump._drain_owner = _drain_owner

    def _unwrap(self):
        from siddhi_tpu_torch.core.event import HostBatch
        from siddhi_tpu_torch.core.query.completion import CompletionPump

        HostBatch.from_columns, CompletionPump._drain_owner = self._orig

    def _mark(self):
        """The clock mark: with the card idle, one fill launched inside a
        host span. It is the first operation the profiler sees on the card,
        and it starts a few microseconds after its launch."""
        from siddhi_tpu_torch.observability.tracing import span

        with span(MARK):
            self._buf.fill_(1.0)

    def stop(self) -> Tuple[list, list]:
        """(spans, device operations), both on the span tracer's clock."""
        from siddhi_tpu_torch.observability.tracing import TRACER

        device = []
        if self.prof is not None:
            import torch
            from torch.autograd import DeviceType

            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            self.prof.__exit__(None, None, None)
            t1 = time.perf_counter()
            events = self.prof.profiler.kineto_results.events()
            n_all = len(events)
            device = [(e.name(), e.start_ns() / 1000.0, e.end_ns() / 1000.0)
                      for e in events if e.device_type() == DeviceType.CUDA]
            device.sort(key=lambda d: d[1])
            print(f"portbench: trace stop {t1 - t0:.2f} s, read {time.perf_counter() - t1:.2f} s,"
                  f" {n_all} events, {len(device)} on the card", file=sys.stderr)
        trace = TRACER.stop()
        self._unwrap()
        spans = [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"], e.get("args") or {})
                 for e in trace["traceEvents"] if e.get("ph") == "X"]
        marks = [s for s in spans if s[0] == MARK]
        spans = [s for s in spans if s[0] != MARK]
        if device:
            if not marks:
                raise RuntimeError("the trace lost its clock mark")
            offset = marks[0][3] - device[0][1]
            device = [(n, a + offset, b + offset) for n, a, b in device[1:]]
        return spans, device


def innermost(spans) -> Tuple[list, list]:
    """The host clock cut where any span opens or closes: (bounds, labels),
    ``labels[i]`` naming the innermost span open over ``bounds[i] ..
    bounds[i + 1]`` (the latest opened, on any thread), or None."""
    events = sorted([(s[2], 1, i) for i, s in enumerate(spans)]
                    + [(s[3], 0, i) for i, s in enumerate(spans)])
    bounds, labels, open_, closed = [], [], [], set()
    for t, opens, i in events:
        if opens:
            heapq.heappush(open_, (-spans[i][2], i))
        else:
            closed.add(i)
        while open_ and open_[0][1] in closed:
            heapq.heappop(open_)
        s = spans[open_[0][1]] if open_ else None
        label = s and s[0] + (f"[{stream_of(s)}]" if stream_of(s) else "")
        if bounds and bounds[-1] == t:
            labels[-1] = label
        else:
            bounds.append(t)
            labels.append(label)
    return bounds, labels


def breakdown(rec: TraceRecord, top: int = 10) -> dict:
    """The device operations with the most time, and the card's idle time
    in the window split by the innermost host span open at each instant."""
    lo, hi = rec.window
    ops: Dict[str, float] = {}
    for name, a, b in rec.device:
        if b > lo and a < hi:
            ops[name] = ops.get(name, 0.0) + (min(b, hi) - max(a, lo)) / 1e6
    busy = sorted((max(a, lo), min(b, hi)) for _n, a, b in rec.device if b > lo and a < hi)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    bounds, labels = innermost(rec.spans)
    idle: Dict[str, float] = {}
    for a, b in gaps:
        i = bisect.bisect_right(bounds, a) - 1
        while a < b:
            end = bounds[i + 1] if i + 1 < len(bounds) else math.inf
            label = labels[i] if i >= 0 else None
            cut = min(b, end)
            key = label or "between spans"
            idle[key] = idle.get(key, 0.0) + (cut - a) / 1e6
            a, i = cut, i + 1
    key = (lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in sorted(ops.items(), key=key)[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=key)[:top]]}
