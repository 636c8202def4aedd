"""IngestPackPool: the multicore host ingest runtime.

Counterpart of ``siddhi_tpu/core/stream/input/pack_pool.py``. Per
"Scaling Ordered Stream Processing on Shared-Memory Multicores"
(PAPERS.md), the pool shards the encode work of one batch across worker
threads as sequence-numbered sub-batch tasks and merges in order:

- **Sequence-numbered sub-batches.** ``plan_events``/``plan_columns``
  split a batch into contiguous row ranges (``ingest_split`` rows each,
  at most one per worker); each task packs its range into a DISJOINT
  slice of the pre-allocated output columns (``core/event.py``
  ``_parallel_from_events``/``_parallel_from_columns``).
- **Ordered merge.** ``run_ordered`` waits the tasks out strictly in
  sequence order — the CompletionPump's dispatch-order discipline
  (``core/query/completion.py``) applied to pack: completion order may
  be arbitrary, observation order never is. New dictionary strings are
  resolved AFTER the ordered wait, serially, in attribute-major row
  order, so the id space is bit-identical to the inline path.
- **Supervision.** A dead or killed packer's sub-batch is RE-PACKED
  inline by the merging thread (never lost), dead threads respawn on the
  next submit, and ``fault_hook`` is the point where
  a test kills or delays one packer.

The pool engages only when ``siddhi_tpu.ingest_pool`` > 0 (default 0 =
today's inline single-thread pack, bit-identical by construction) and a
batch is big enough to span >= 2 sub-batches.

Where the parallelism can pay: numpy slice copies and dtype conversions
release the GIL, so those parts of sub-batches overlap on real cores.
The string probe does not: the port's native dictionary probe walks
``PyObject*`` arrays through ``ctypes.PyDLL`` and holds the GIL, as does
the EVENTS path's per-row work, so string-heavy packs serialize on the
GIL whatever the pool size. ``subbatches``, ``repacked_subbatches`` and
``worker_deaths`` count what the pool did.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, List, Optional, Tuple

from siddhi_tpu_torch.query_api.definitions import AttrType

log = logging.getLogger(__name__)


class _Task:
    __slots__ = ("seq", "lo", "hi", "fn", "done", "error", "elapsed_ms")

    def __init__(self, seq: int, lo: int, hi: int, fn: Callable):
        self.seq = seq
        self.lo = lo
        self.hi = hi
        self.fn = fn
        self.done = threading.Event()
        self.error: Optional[Exception] = None
        self.elapsed_ms = 0.0


class IngestPackPool:
    """Per-app ordered pack pool (see module docstring).

    Thread contract: ``run_ordered`` may be called from any producer /
    junction-worker thread (several concurrently — tasks interleave on
    the shared queue, each caller waits only its own). Workers take no
    lock; the pool's own bookkeeping lock guards ``_threads`` and
    ``_gen`` and is a leaf (nothing is acquired under it). ``_stopped``
    is a double-checked shutdown gate, re-verified under the lock."""

    def __init__(self, app_context, workers: int, split_rows: int = 8192):
        if workers <= 0:
            raise ValueError("IngestPackPool needs workers > 0")
        self.app_context = app_context
        self.workers = int(workers)
        self.split_rows = max(256, int(split_rows))
        self._tasks: "queue.Queue" = queue.Queue()
        self._lock = threading.RLock()
        self._threads: List[threading.Thread] = []
        self._gen = 0
        self._stopped = False
        self.subbatches = 0
        self.worker_deaths = 0
        self.repacked_subbatches = 0
        # fault-injection point: polled by each worker before running a
        # task — a raising hook kills THAT worker (its task is re-packed
        # by the merge thread); a sleeping hook delays one sub-batch,
        # forcing out-of-order completion the ordered merge must absorb
        self.fault_hook = None
        with self._lock:
            self._spawn_missing_locked()

    # ----------------------------------------------------------- lifecycle

    def alive_workers(self) -> int:
        with self._lock:
            return sum(1 for t in self._threads if t.is_alive())

    def _spawn_missing_locked(self) -> int:
        """Replace dead worker threads (pool lock held). Returns how many
        were spawned."""
        if self._stopped:
            # re-checked under the lock: a run_ordered that passed its
            # unlocked gate while shutdown() ran must not respawn workers
            # nobody will ever send a stop sentinel to
            return 0
        self._threads = [t for t in self._threads if t.is_alive()]
        n = 0
        while len(self._threads) < self.workers:
            self._gen += 1
            t = threading.Thread(
                target=self._loop, daemon=True,
                name=f"ingest-pack-{self.app_context.name}-g{self._gen}")
            t.start()
            self._threads.append(t)
            n += 1
        return n

    def shutdown(self) -> None:
        with self._lock:
            # under the lock: serializes against a concurrent
            # _spawn_missing_locked so no worker spawns after the
            # sentinels are counted out
            self._stopped = True
            threads = self._threads
            self._threads = []
        for _ in threads:
            self._tasks.put(None)
        for t in threads:
            t.join(timeout=5)

    # ------------------------------------------------------------ planning

    def plan_events(self, n: int, definition) -> Optional[List[Tuple[int, int]]]:
        """Sub-batch ranges for an Event-path pack, or None when the
        batch stays inline: too small to span two sub-batches, pool shut
        down, a pool worker itself is packing (no nested submits), or
        the schema carries OBJECT (set-valued) attributes — their
        variable-width '#set' companions need the whole batch."""
        if self._stopped or _IN_WORKER.active:
            return None
        if any(a.type == AttrType.OBJECT for a in definition.attributes):
            return None
        return self._ranges(n)

    def plan_columns(self, data, definition) -> Optional[List[Tuple[int, int]]]:
        """Sub-batch ranges for a columnar pack. Requires every supplied
        attribute column to be exactly batch-length (the inline path
        dictionary-encodes a LONGER string column in full — splitting
        would change the id-assignment order, so such batches stay
        inline)."""
        if self._stopped or _IN_WORKER.active:
            return None
        first = next(iter(data.values()))
        n = len(first)
        for attr in definition.attributes:
            col = data.get(attr.name)
            if col is None or len(col) != n:
                return None
        return self._ranges(n)

    def _ranges(self, n: int) -> Optional[List[Tuple[int, int]]]:
        split = self.split_rows
        n_chunks = min(self.workers, (n + split - 1) // split)
        if n_chunks < 2:
            return None
        per = (n + n_chunks - 1) // n_chunks
        return [(lo, min(lo + per, n)) for lo in range(0, n, per)]

    # ------------------------------------------------------------- running

    def run_ordered(self, chunks: List[Tuple[int, int]],
                    fn: Callable[[int, int], None]) -> List[float]:
        """Submit every sub-batch, then wait them out strictly in
        sequence order (dispatch-order discipline). A sub-batch whose
        worker died (injected kill, unexpected error escaping the pack
        fn is re-raised) is re-packed INLINE here — the batch is never
        lost, at worst slower. Returns per-sub-batch service times in
        sequence order."""
        with self._lock:
            self._spawn_missing_locked()
        tasks = [_Task(seq, lo, hi, fn)
                 for seq, (lo, hi) in enumerate(chunks)]
        for t in tasks:
            self._tasks.put(t)
        out: List[float] = []
        for t in tasks:
            waited = 0.0
            while not t.done.wait(timeout=1.0):
                waited += 1.0
                if self._stopped and self.alive_workers() == 0:
                    # shutdown raced this pack: every worker drained its
                    # stop sentinel (queued BEFORE these tasks) and
                    # exited, so nobody will ever claim them — pack the
                    # abandoned sub-batch inline instead of wedging the
                    # producer thread forever. Safe: zero live workers
                    # means zero concurrent writers to these slices.
                    if not t.done.is_set():
                        t0 = time.perf_counter()
                        fn(t.lo, t.hi)
                        t.elapsed_ms = (time.perf_counter() - t0) * 1000.0
                        t.done.set()
                    break
                if waited >= 30.0:
                    waited = 0.0
                    log.warning(
                        "ingest pack pool of app '%s': sub-batch %d "
                        "[%d:%d) still pending after 30s (wedged "
                        "packer?)", self.app_context.name, t.seq, t.lo,
                        t.hi)
            if t.error is not None:
                # dead packer: re-pack this sub-batch on the merge
                # thread — ordered, exact, never lost
                t0 = time.perf_counter()
                fn(t.lo, t.hi)
                t.elapsed_ms = (time.perf_counter() - t0) * 1000.0
                with self._lock:
                    self.repacked_subbatches += 1
                    self._spawn_missing_locked()
            out.append(t.elapsed_ms)
        with self._lock:
            self.subbatches += len(tasks)
        return out

    # -------------------------------------------------------------- worker

    def _loop(self) -> None:
        _IN_WORKER.active = True
        while True:
            task = self._tasks.get()
            if task is None:
                return
            hook = self.fault_hook
            if hook is not None:
                try:
                    hook(self)
                except Exception as e:  # noqa: BLE001 — injected death
                    with self._lock:
                        self.worker_deaths += 1
                    task.error = e
                    task.done.set()
                    log.warning("ingest pack worker killed: %s", e)
                    return
            t0 = time.perf_counter()
            try:
                task.fn(task.lo, task.hi)
                task.elapsed_ms = (time.perf_counter() - t0) * 1000.0
            except Exception as e:  # noqa: BLE001 — surfaced via re-pack
                task.error = e
            finally:
                task.done.set()


# a pool worker must never re-submit to the pool from inside a pack fn
# (nested ordered waits could exhaust the workers): plan_* checks this
# thread-local and keeps worker-side packs inline
class _InWorker(threading.local):
    active = False


_IN_WORKER = _InWorker()
