"""Deterministic fault injection for the resilience test suite.

Counterpart of ``siddhi_tpu/resilience/faults.py``. Every injection is an explicit hook at a point the production code already
owns — no monkeypatching of framework internals from tests:

- junction workers poll an optional ``fault_hook`` at the top of each
  drain iteration (``core/stream/junction.py``): a hook can raise
  (simulated worker crash) or block (simulated wedge);
- the ingest pack pool polls its own ``fault_hook`` per sub-batch
  (``core/stream/input/pack_pool.py``);
- the batch-journey stages take planted service delays
  (``observability/journey.inject_delay``): the critical-path report's
  known bottleneck;
- sink publishes go through the Sink SPI object, which the injector
  wraps to fail the first N calls with the transport's own
  ``ConnectionUnavailableException``.

All injections are one-shot or counted, so tests are deterministic; the
injector restores everything it touched on ``clear()``. The peer faults
(``drop_peer``/``restore_peer``) arm the fault slot of the bounded cluster
pull (``parallel/distributed.guarded_pull``): a dead peer without waiting
out the pull timeout.
"""

from __future__ import annotations

import threading
from typing import Optional


class WorkerKilled(Exception):
    """Raised inside a junction worker by ``kill_worker`` — simulates the
    worker thread dying mid-drain (the junction treats ANY exception out
    of the fault hook as a worker death)."""


class FaultInjector:  # graftlint: disable=R8 — deterministic test tooling:
    # arming happens on the test thread before the faulted component
    # runs, and every injection is one-shot or counted; the bookkeeping
    # lists are never touched by two threads at once
    def __init__(self):
        self._wedge_release = threading.Event()
        self._wedged = threading.Event()
        self._patched_sinks = []          # (sink, original_publish)
        self._peer_fault_armed = False
        self._flood_threads = []          # non-blocking flood producers
        self._delayed_junctions = []      # persistent delay_worker targets
        self._delayed_pools = []          # armed ingest pack pools

    # ------------------------------------------------- junction workers

    def kill_worker(self, junction) -> None:
        """Arm a one-shot crash: the next drain iteration raises
        ``WorkerKilled`` and the worker thread exits. Any in-flight batch
        stays parked on the junction for the replacement worker."""
        def hook(j):
            j.fault_hook = None
            raise WorkerKilled(f"injected kill on junction "
                               f"'{j.definition.id}'")

        junction.fault_hook = hook

    def wedge_worker(self, junction) -> None:
        """Arm a one-shot wedge: the next drain iteration blocks until
        ``release()``. The thread stays alive but stops heartbeating —
        exactly the failure the supervisor's beat-stall detector targets.
        A released stale worker exits on its generation check without
        touching the queue."""
        self._wedge_release.clear()
        self._wedged.clear()

        def hook(j):
            j.fault_hook = None
            self._wedged.set()
            self._wedge_release.wait()

        junction.fault_hook = hook

    def wait_wedged(self, timeout: float = 10.0) -> bool:
        """Block until a wedged worker actually entered the wedge."""
        return self._wedged.wait(timeout)

    def release(self) -> None:
        """Wake every worker currently blocked in a wedge hook."""
        self._wedge_release.set()

    def delay_worker(self, junction, seconds: float,
                     persistent: bool = False) -> None:
        """Arm a delivery delay (a slow device step seen from the
        junction's side): the next drain iteration sleeps ``seconds``.
        ``persistent=True`` keeps the delay armed on EVERY iteration —
        the deterministic way to make the @Async queue the bottleneck
        (the critical-path profiler's queue-attribution tests plant
        exactly this); disarmed by :meth:`clear`."""
        import time

        if persistent:
            def hook(j):
                time.sleep(seconds)

            self._delayed_junctions.append(junction)
        else:
            def hook(j):
                j.fault_hook = None
                time.sleep(seconds)

        junction.fault_hook = hook

    # ---------------------------------------------- ingest pack-pool workers

    def kill_packer(self, pool) -> None:
        """Arm a one-shot crash on the ingest pack pool
        (``core/stream/input/pack_pool.py``): the next sub-batch task's
        worker dies mid-claim — the merging thread re-packs that
        sub-batch inline (never lost) and the pool/supervisor respawn
        the thread."""
        def hook(p):
            p.fault_hook = None
            raise WorkerKilled("injected kill on ingest pack worker")

        pool.fault_hook = hook
        self._delayed_pools.append(pool)

    def delay_packer(self, pool, seconds: float) -> None:
        """Arm a one-shot delivery delay on ONE ingest pack worker: the
        next sub-batch completes ``seconds`` late, forcing out-of-order
        sub-batch completion — the scenario the pool's ordered merge
        must absorb bit-identically."""
        import time as _time

        def hook(p):
            p.fault_hook = None
            _time.sleep(seconds)

        pool.fault_hook = hook
        self._delayed_pools.append(pool)

    def delay_stage(self, stage: str, seconds: float) -> None:
        """Plant a persistent service delay inside an instrumented
        batch-journey stage (``observability/journey.py`` — ``'pack'``
        today): every ``HostBatch`` pack sleeps ``seconds`` while
        journey tracing is enabled, making that stage the known
        bottleneck the critical-path report must name. Disarmed by
        :meth:`clear`."""
        from siddhi_tpu_torch.observability import journey

        journey.inject_delay(stage, seconds)

    def flood_stream(self, junction, ratio: float = 10.0,
                     base_events: Optional[int] = None,
                     make_data=None, chunk: int = 256,
                     block: bool = True):
        """Deterministic overload injection: publish ``ratio ×`` the
        junction's @Async buffer size (or ``ratio × base_events``) events
        through ``junction.send_events`` — the exact path real producers
        use, so quota admission, shed policies, and backpressure all
        engage (``resilience/overload.py``). The tests share this one
        injection path, alongside kill/wedge/delay.

        ``make_data(i)`` supplies each event's data row; the default
        synthesizes one from the stream definition's attribute types.
        ``block=True`` sends inline and returns the event count;
        ``block=False`` floods from a daemon thread and returns it (the
        caller joins) — the producer-blocking case IS the scenario some
        tests flood for. Events are timestamped by the app clock."""
        import time as _time

        from siddhi_tpu_torch.core.event import Event
        from siddhi_tpu_torch.query_api.definitions import AttrType

        q = getattr(junction, "_queue", None)
        base = (base_events if base_events is not None
                else (q.maxsize if q is not None and q.maxsize > 0
                      else 1024))
        total = max(int(ratio * base), 1)
        if make_data is None:
            attrs = junction.definition.attributes

            def make_data(i, _attrs=attrs):
                row = []
                for a in _attrs:
                    if a.type == AttrType.STRING:
                        row.append(f"f{i % 8}")
                    elif a.type in (AttrType.FLOAT, AttrType.DOUBLE):
                        row.append(float(i))
                    elif a.type == AttrType.BOOL:
                        row.append(bool(i % 2))
                    else:
                        row.append(i)
                return row

        def _flood():
            tsg = junction.app_context.timestamp_generator
            sent = 0
            while sent < total:
                n = min(chunk, total - sent)
                now = tsg.current_time()
                junction.send_events([
                    Event(timestamp=now, data=make_data(sent + k))
                    for k in range(n)])
                sent += n
            return sent

        if block:
            return _flood()
        t = threading.Thread(target=_flood, daemon=True,
                             name=f"flood-{junction.definition.id}")
        t.start()
        self._flood_threads.append(t)
        return t

    # ------------------------------------------------------ cluster peers

    def drop_peer(self, what: str = "injected peer death") -> None:
        """Make every later ``guarded_pull`` raise ``ClusterPeerError`` at
        once — a peer process presumed dead without waiting out the pull
        timeout. Cleared by ``restore_peer()``/``clear()``."""
        from siddhi_tpu_torch.parallel import distributed

        def hook(label):
            raise distributed.ClusterPeerError(
                f"{label}: {what} — restart the cluster and restore from "
                f"the last snapshot revision")

        distributed._fault_hook = hook
        self._peer_fault_armed = True

    def restore_peer(self) -> None:
        from siddhi_tpu_torch.parallel import distributed

        distributed._fault_hook = None
        self._peer_fault_armed = False

    # -------------------------------------------------------------- sinks

    def fail_publishes(self, sink, n: int = 1,
                       exception: Optional[Exception] = None) -> None:
        """Fail the next ``n`` ``publish`` calls on this Sink with
        ``ConnectionUnavailableException`` (or the given exception), then
        pass through — the shape of a transport blip the retry policy must
        absorb."""
        from siddhi_tpu_torch.core.stream.input.source import (
            ConnectionUnavailableException,
        )

        original = sink.publish
        box = {"left": int(n)}

        def publish(payload):
            if box["left"] > 0:
                box["left"] -= 1
                raise (exception if exception is not None
                       else ConnectionUnavailableException(
                           "injected publish failure"))
            return original(payload)

        sink.publish = publish
        self._patched_sinks.append((sink, original))

    # ------------------------------------------------------------ cleanup

    def clear(self) -> None:
        self.release()
        if self._peer_fault_armed:
            self.restore_peer()
        for sink, original in self._patched_sinks:
            sink.publish = original
        self._patched_sinks.clear()
        for t in self._flood_threads:
            t.join(timeout=10)
        self._flood_threads.clear()
        for j in self._delayed_junctions:
            j.fault_hook = None
        self._delayed_junctions.clear()
        for p in self._delayed_pools:
            p.fault_hook = None
        self._delayed_pools.clear()
        from siddhi_tpu_torch.observability import journey

        journey.clear_delays()
