"""The device profiler trace: ``torch.profiler`` into a Chrome trace file.

Counterpart of the reference's ``jax.profiler`` trace behind
``SiddhiAppRuntime.start_trace``/``stop_trace`` and ``POST
/profile/device/start|stop``: a process-level profiler of CPU and, on the
card, CUDA activity (every kernel, a CUDA-graph replay's included, under
its own name: ``ring_exchange_cols_kernel``, ``distinct_scan_hash``,
...). One trace runs at a time in a process; ``stop()`` writes
``trace.<pid>.<n>.json`` under the directory ``start()`` was given and
returns its path.

torch's profiler is bound to the thread that starts it: its CPU side
records that thread's ops, and only that thread may stop it (a stop from
another thread finds no session). So ``stop()`` must come from the
thread that called ``start()``; the REST service runs both on one
thread of its own. Its CUDA side (CUPTI) records every kernel of the
process, whichever thread launched it; the host pipeline's timeline
across threads is the span tracer's (``observability/tracing.py``).

Both clocks are one: the profiler stamps its events in Unix ns and its
file gives each ``ts`` as microseconds after ``baseTimeNanoseconds``; the
span tracer states the Unix ns of its own ``ts`` 0 (``epoch_unix_ns``).
So ``stop()`` writes the span tracer's spans of the trace's interval into
the file it writes, moved onto the file's time base, whenever the tracer
holds spans: one timeline in which each gap between the card's kernels
lies under the host work of its instant. It takes a snapshot and leaves
the span tracer running.
"""

from __future__ import annotations

import json
import os
import threading
import time

_lock = threading.Lock()
_active = None          # (profiler, log_dir, starting thread, Unix ns at start)
_written = 0            # traces written by this process (file names)


def start(log_dir: str) -> str:
    """Start the process's device trace into ``log_dir`` on this thread;
    raises ``RuntimeError`` when one is already running."""
    global _active
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _lock:
        if _active is not None:
            raise RuntimeError("a trace is already running")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        _active = (prof, log_dir, threading.get_ident(), time.time_ns())
    return log_dir


def stop() -> str:
    """Stop the running trace and write it; returns the file's path.
    Raises ``RuntimeError`` when no trace is running, or when this is not
    the thread that started it."""
    global _active, _written
    import torch

    with _lock:
        if _active is None:
            raise RuntimeError("no trace is running")
        prof, log_dir, owner, t_start = _active
        if owner != threading.get_ident():
            raise RuntimeError("the device trace is stopped by the thread that "
                               "started it")
        _active = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()    # the traced kernels have ended
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        _written += 1
        path = os.path.join(log_dir, f"trace.{os.getpid()}.{_written}.json")
        t_stop = time.time_ns()
        prof.export_chrome_trace(path)
        _merge_spans(path, t_start, t_stop)
    return path


def _merge_spans(path: str, t_start: int, t_stop: int) -> None:
    """Add the span tracer's spans that overlap ``t_start .. t_stop`` (Unix
    ns) to the Chrome trace at ``path``, their ``ts`` moved from the
    tracer's epoch onto the file's ``baseTimeNanoseconds`` (0 where the
    file states none: its ``ts`` are then Unix microseconds). Nothing when
    the tracer holds no span."""
    from siddhi_tpu_torch.observability.tracing import TRACER

    if not len(TRACER):
        return
    spans = TRACER.to_chrome_trace()
    epoch = spans["otherData"]["epoch_unix_ns"]
    lo_us, hi_us = (t_start - epoch) / 1000.0, (t_stop - epoch) / 1000.0
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    shift_us = (epoch - int(trace.get("baseTimeNanoseconds", 0))) / 1000.0
    events = trace.setdefault("traceEvents", [])
    tids = set()
    for ev in spans["traceEvents"]:
        if ev.get("ph") == "X" and ev["ts"] + ev["dur"] >= lo_us and ev["ts"] <= hi_us:
            events.append(dict(ev, ts=round(ev["ts"] + shift_us, 3)))
            tids.add((ev["pid"], ev["tid"]))
    # the spans' rows, apart from the profiler's (a Python thread ident is
    # not the system thread id the profiler's rows carry)
    events.extend({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                   "args": {"name": "siddhi_tpu_torch spans"}}
                  for pid, tid in sorted(tids))
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)

