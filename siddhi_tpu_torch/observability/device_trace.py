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
"""

from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_active = None          # (profiler, log_dir, starting thread) of the running trace
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
        _active = (prof, log_dir, threading.get_ident())
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
        prof, log_dir, owner = _active
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
        prof.export_chrome_trace(path)
    return path

