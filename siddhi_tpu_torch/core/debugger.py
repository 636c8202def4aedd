"""SiddhiDebugger: query IN/OUT breakpoints with suspend/step semantics.

Counterpart of ``siddhi_tpu/core/debugger.py`` (host code: the same
debugger); ``get_query_state`` pulls the query's state tensors to numpy
with the snapshot's ``_to_host``. A step that runs as a CUDA-graph
replay (``core/query/step_graph.py``) still enters through the runtime's
delivery methods and leaves through its ``_emit``, so both checkpoints
see it; a runtime's ``_state`` is always its own tensors (a shared
program's slot is copied in and out inside the step call), so the state
read at a checkpoint is the app's.

Mirror of reference ``core/debugger/SiddhiDebugger.java`` +
``SiddhiDebuggerCallback``: breakpoints attach at a query's input (before
the step processes a chunk) or output (before callbacks fire). When a
batch hits an acquired breakpoint (or a pending ``next()``), the callback
fires and the pump thread BLOCKS on a semaphore until ``next()`` or
``play()`` releases it (``SiddhiDebugger.java:182-190``
checkBreakPoint/next/play):

- ``play()``  — resume; run until the next ACQUIRED breakpoint.
- ``next()``  — resume; the released thread breaks again at the very
  next checkpoint it reaches, acquired or not (single-step). The flag is
  thread-local, like the reference's ``threadLocalNextFlag``.

Calling ``next()``/``play()`` from inside the callback is supported (the
reference test idiom): the semaphore permit accumulates, so the
subsequent ``acquire`` returns immediately.

Usage::

    debugger = runtime.debug()
    debugger.set_debugger_callback(cb)          # cb(events, qname, terminal, dbg)
    debugger.acquire_break_point('query1', SiddhiDebugger.QueryTerminal.IN)
    ...
    debugger.next()   # from the callback or another thread
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Dict, List, Optional, Tuple


class SiddhiDebugger:
    class QueryTerminal(enum.Enum):
        IN = "IN"
        OUT = "OUT"

    def __init__(self, app_runtime):
        self.app_runtime = app_runtime
        self._callback: Optional[Callable] = None
        self._wrapped: Dict[Tuple[str, "SiddhiDebugger.QueryTerminal"], tuple] = {}
        self._active: set = set()                 # acquired breakpoints
        # suspend/step machinery (SiddhiDebugger.java:56-69):
        self._bp_lock = threading.Semaphore(0)    # breakPointLock
        self._enable_next = False                 # enableNext (cross-thread)
        self._tls = threading.local()             # threadLocalNextFlag
        # every query terminal is a checkpoint (the reference calls
        # checkBreakPoint unconditionally from each query valve), so a
        # next() can single-step into queries with no acquired breakpoint
        for qname in app_runtime.query_runtimes:
            for terminal in SiddhiDebugger.QueryTerminal:
                self._instrument(qname, terminal)

    def set_debugger_callback(self, callback: Callable):
        """callback(events, query_name, terminal, debugger)."""
        self._callback = callback

    # ------------------------------------------------------------- stepping

    def next(self):
        """Release the suspended pump thread and break again at the NEXT
        checkpoint it reaches, whether or not a breakpoint is acquired
        there (reference ``next()``)."""
        self._enable_next = True
        self._bp_lock.release()

    def play(self):
        """Release the suspended pump thread; it runs until the next
        ACQUIRED breakpoint (reference ``play()``)."""
        self._bp_lock.release()

    def get_query_state(self, query_name: str):
        """Live state snapshot of one query (reference ``getQueryState``
        via SnapshotService.queryState). Safe from the debugger callback
        (the pump thread already holds the query's RLock) AND from a
        controller thread while the pump is SUSPENDED at an OUT
        breakpoint — there the pump holds the lock across the suspension,
        so a blocking acquire would deadlock the suspend-inspect-resume
        workflow; after a short timeout we read without the lock (the
        suspended pump is quiescent: its state update already finished)."""
        from siddhi_tpu_torch.core.util.snapshot import SnapshotService

        q = self.app_runtime.query_runtimes.get(query_name)
        if q is None:
            raise KeyError(f"unknown query '{query_name}'")
        locked = q._lock.acquire(timeout=1.0)
        try:
            return {
                "state": (SnapshotService(self.app_runtime)._to_host(q._state)
                          if q._state is not None else None),
                "host_window": (q.host_window.snapshot()
                                if q.host_window is not None else None),
            }
        finally:
            if locked:
                q._lock.release()

    # ------------------------------------------------------------ breakpoints

    def acquire_break_point(self, query_name: str, terminal: "SiddhiDebugger.QueryTerminal"):
        if query_name not in self.app_runtime.query_runtimes:
            raise KeyError(f"unknown query '{query_name}'")
        self._active.add((query_name, terminal))

    def _instrument(self, query_name: str, terminal: "SiddhiDebugger.QueryTerminal"):
        rt = self.app_runtime.query_runtimes.get(query_name)
        if rt is None:
            raise KeyError(f"unknown query '{query_name}'")
        key = (query_name, terminal)
        if key in self._wrapped:
            return
        dbg = self

        if terminal == SiddhiDebugger.QueryTerminal.IN:
            targets = [n for n in ("receive_batch", "process_stream_batch",
                                   "process_side_batch", "process_batch")
                       if hasattr(rt, n)]
            originals = []
            for name in targets:
                orig = getattr(rt, name)

                def wrapper(*args, _orig=orig, _rt=rt, **kw):
                    from siddhi_tpu_torch.core.event import HostBatch

                    batch = next((a for a in args if isinstance(a, HostBatch)), None)
                    dbg._checkpoint(lambda: _decode(batch, _rt),
                                    query_name, terminal)
                    return _orig(*args, **kw)

                setattr(rt, name, wrapper)
                originals.append((name, orig))
            self._wrapped[key] = tuple(originals)
        else:
            orig = rt._emit

            def out_wrapper(out_batch, _orig=orig, _rt=rt):
                dbg._checkpoint(lambda: _decode(out_batch, _rt, output=True),
                                query_name, terminal)
                return _orig(out_batch)

            rt._emit = out_wrapper
            self._wrapped[key] = (("_emit", orig),)

    def release_break_point(self, query_name: str, terminal: "SiddhiDebugger.QueryTerminal"):
        self._active.discard((query_name, terminal))

    def release_all_break_points(self):
        self._active.clear()

    def detach(self):
        """Remove the checkpoint instrumentation entirely (not part of the
        reference surface — its checkpoints are compiled in permanently)."""
        self._active.clear()
        for (qname, _terminal), originals in self._wrapped.items():
            rt = self.app_runtime.query_runtimes.get(qname)
            if rt is None:
                continue
            for name, orig in originals:
                setattr(rt, name, orig)
        self._wrapped.clear()

    # ---------------------------------------------------------------- fire

    def _checkpoint(self, decode: Callable[[], List], query_name: str, terminal):
        """Reference ``checkBreakPoint``: a checkpoint is "hit" when its
        breakpoint is acquired OR this thread was released with ``next()``.
        On a hit: decode the batch, fire the callback, then suspend the
        pump thread until next()/play() releases it."""
        is_next = getattr(self._tls, "next", False)
        hit = (query_name, terminal) in self._active or is_next
        if not hit:
            return
        events = decode()
        if not events:
            return
        if is_next:
            self._tls.next = False
        if self._callback is not None:
            self._callback(events, f"{query_name}:{terminal.value}", terminal, self)
        self._bp_lock.acquire()
        if self._enable_next:
            # must be set from the released thread itself (the reference
            # keeps this out of next()/play() for the same reason)
            self._tls.next = True
            self._enable_next = False


def _decode(batch, rt, output: bool = False) -> List:
    from siddhi_tpu_torch.core.event import HostBatch

    if not isinstance(batch, HostBatch):
        return []
    try:
        if output:
            return batch.to_events(rt.output_attrs, rt.dictionary)
        defn = rt.input_definition
        if defn is None:    # NFA/join inputs: per-stream definitions differ
            return []
        return batch.to_events(
            [(a.name, a.type) for a in defn.attributes], rt.dictionary)
    except Exception:
        return []
