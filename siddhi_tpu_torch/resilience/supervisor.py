"""App supervision: worker heartbeats and the pipeline's wedge check.

Counterpart of the worker half of ``siddhi_tpu/resilience/supervisor.py``.
``@Async`` junctions run plain host threads, and on the card each one
drives a stream of CUDA-graph replays into the app's ``CompletionPump``:

- **Worker heartbeats.** Every @Async worker bumps ``_beats`` each drain
  iteration and polls its queue with a bounded wait, so a healthy worker
  beats at least ~10 times a second even when idle. A worker whose
  thread died is restarted at the next tick; one whose beats stalled past
  ``wedge_timeout_s`` is presumed wedged and REPLACED. The queue and any
  unit in delivery stay on the junction, and the junction's generation
  token makes a stale worker that wakes later exit before it touches the
  queue or the card (``core/stream/junction.py``). Batches already in
  flight belong to the pump, not to the worker: the replacement drains
  them in order, without loss or a second emit.
- **Dead packers.** The tick respawns dead ingest pack workers
  (``IngestPackPool.heal``); their sub-batches were already re-packed by
  the merging thread.
- **The pipeline's wedge check.** A pump entry whose meta never arrives
  means a hung device step: the producers keep packing while nothing
  emits, which the worker heartbeats cannot see. ``_check_pump`` counts
  ``resilience.pump_wedges`` once an episode and logs it; it detects
  only.
- **Producer backpressure.** A producer whose bounded enqueue wait timed
  out calls ``notify_backpressure``, which checks that junction's worker
  at once instead of at the next tick.

- **Peer liveness.** ``PeerMonitor`` is a TCP liveness listener with
  probes: every process binds one, and a supervisor probes its peers'
  each tick. The cluster fabric's worker supervisor
  (``cluster/supervisor.py``) watches its worker processes with it; an
  app supervisor given one folds a lost heartbeat into peer recovery.
- **Peer recovery.** ``StreamJunction.handle_error`` notifies the
  supervisor of every processing error; on a peer failure
  (``is_peer_failure``: ``ClusterPeerError`` from the bounded pull or a
  collective of the process group, ``parallel/distributed.py``) the
  supervisor counts ``resilience.peer_failures`` and runs the protocol
  ``distributed.py`` promises, exactly once: abandon the wedged runtime
  (collectives cannot be cancelled: the stuck waits stay parked in daemon
  threads), rebuild on the survivors (caller-supplied: a fresh runtime
  over ``local_survivor_mesh()`` or a re-formed process group),
  ``restore_last_revision()`` from the persistence store, replay the
  ingest WAL suffix, and resume the sources (``PeerRecovery``; the new
  runtime counts ``resilience.peer_recoveries``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from siddhi_tpu_torch.analysis.guards import guarded
from siddhi_tpu_torch.analysis.locks import make_lock

log = logging.getLogger(__name__)


@guarded
class PeerMonitor:
    """Socket liveness heartbeats between processes.

    Every process binds a tiny TCP listener; a supervisor probes its
    peers' listeners each tick, and a peer that was reachable once and
    then refuses ``misses`` probes in a row is declared dead (the listener
    of a process killed outright drops at once, so detection takes about
    ``misses`` ticks). A peer never reached yet is "not up yet", never
    dead. Each accepted connection is closed at once: the connect is the
    beat."""

    # watch/unwatch/rearm run on supervisor threads while poll_dead's
    # bookkeeping runs on the tick thread; probes happen OUTSIDE the lock
    # (a slow connect must not block an unwatch)
    GUARDED_BY = {"_peers": "app_supervisor", "_dead": "app_supervisor"}

    def __init__(self, listen_port: int = 0, probe_timeout_s: float = 1.0,
                 misses: int = 3):
        import socket

        self.probe_timeout_s = float(probe_timeout_s)
        self.misses = int(misses)
        self._lock = make_lock("app_supervisor")
        self._peers = {}          # addr -> {"seen": bool, "missed": int}
        self._dead = set()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", listen_port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._accepting = True
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"peer-monitor-:{self.port}").start()

    def _accept_loop(self) -> None:
        while self._accepting:
            try:
                conn, _addr = self._sock.accept()
                conn.close()          # the successful connect IS the beat
            except OSError:
                return

    def watch(self, host: str, port: int) -> None:
        with self._lock:
            self._peers[(host, int(port))] = {"seen": False, "missed": 0}

    def unwatch(self, host: str, port: int) -> None:
        """Stop probing an address (a respawned peer binds a NEW port; the
        old listener must not linger as a perpetual corpse)."""
        addr = (host, int(port))
        with self._lock:
            self._peers.pop(addr, None)
            self._dead.discard(addr)

    def rearm(self, host: str, port: int) -> None:
        """Forget a peer's death and watch its address from scratch: the
        replacement is "not up yet" until its listener is first reached,
        never at once declared dead again."""
        addr = (host, int(port))
        with self._lock:
            self._dead.discard(addr)
            self._peers[addr] = {"seen": False, "missed": 0}

    def poll_dead(self) -> list:
        """Probe every watched peer once; returns the NEWLY dead
        addresses."""
        import socket

        with self._lock:
            targets = [(addr, st) for addr, st in self._peers.items()
                       if addr not in self._dead]
        newly = []
        for addr, st in targets:
            try:
                socket.create_connection(addr, self.probe_timeout_s).close()
                ok = True
            except OSError:
                ok = False
            with self._lock:
                if self._peers.get(addr) is not st:
                    continue    # unwatched or rearmed mid-probe: stale result
                if ok:
                    st["seen"] = True
                    st["missed"] = 0
                elif st["seen"]:
                    st["missed"] += 1
                    if st["missed"] >= self.misses:
                        self._dead.add(addr)
                        newly.append(addr)
        return newly

    def close(self) -> None:
        import socket

        self._accepting = False
        try:
            # wakes the accept thread: a listening socket closed under a
            # blocked accept() would go on accepting
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def is_peer_failure(error: Exception) -> bool:
    """``ClusterPeerError`` is the bounded pull's timeout and the wrapped
    failure of a process group's collective (``ops/exchange.py``); a dead
    peer's transport can also surface as a raw error from
    ``torch.distributed`` itself ("Connection closed by peer" /
    "connection reset by peer", gloo noticing the closed socket). Both
    mean the same for supervision. The substring match is scoped to
    ``torch.distributed``'s exception types: an app-level socket error (a
    flaky SINK client also says "reset by peer") must not tear down a
    healthy runtime."""
    from siddhi_tpu_torch.parallel.distributed import ClusterPeerError

    if isinstance(error, ClusterPeerError):
        return True
    mod = getattr(type(error), "__module__", "") or ""
    if not mod.startswith("torch.distributed"):
        return False
    msg = str(error).lower()
    return "closed by peer" in msg or "reset by peer" in msg


def abandon_runtime(app_runtime) -> None:
    """Best-effort, non-blocking teardown of a runtime presumed wedged on
    a dead peer: no drains (they would block on the same dead collective),
    no worker joins. Stops ingest, sources, triggers and timers."""
    app_runtime.app_context.stopped = True
    try:
        app_runtime.app_context.timestamp_generator.stop_heartbeat()
    except Exception:  # noqa: BLE001 — best effort
        pass
    for sr in getattr(app_runtime, "source_runtimes", []):
        try:
            sr.shutdown()
        except Exception:  # noqa: BLE001 — best effort
            pass
    for tr in getattr(app_runtime, "trigger_runtimes", []):
        try:
            tr.stop()
        except Exception:  # noqa: BLE001 — best effort
            pass
    for j in app_runtime.junctions.values():
        j._running = False
        j._gen += 1          # any parked worker exits on its next wake
    sched = app_runtime.app_context.scheduler
    if sched is not None:
        try:
            sched.shutdown()
        except Exception:  # noqa: BLE001 — best effort
            pass


class PeerRecovery:
    """One execution of the peer-death recovery protocol.

    ``rebuild()`` must return a FRESH ``SiddhiAppRuntime`` for the same
    app, already wired to the persistence store and with its callbacks
    re-attached — on the survivor's own device
    (``distributed.local_survivor_mesh()``) or a re-formed cluster. The
    old runtime is abandoned, the last revision restored, the WAL suffix
    replayed, and sources resumed."""

    def __init__(self, rebuild: Callable[[], object], wal=None,
                 on_recovered: Optional[Callable[[object, Optional[str]], None]] = None):
        self.rebuild = rebuild
        self.wal = wal
        self.on_recovered = on_recovered

    def recover(self, old_runtime=None):
        """Returns ``(new_runtime, restored_revision)``."""
        from siddhi_tpu_torch.resilience import stat_count

        if old_runtime is not None:
            abandon_runtime(old_runtime)
        new_rt = self.rebuild()
        if self.wal is not None and getattr(new_rt.app_context, "ingest_wal", None) is None:
            # the survivor's log guards the NEW incarnation too, gauges
            # included: after a recovery is when WAL growth must show
            new_rt.app_context.ingest_wal = self.wal
            from siddhi_tpu_torch.resilience.replay import register_wal_gauges

            register_wal_gauges(new_rt.app_context)
        revision = new_rt.restore_last_revision()
        # restore_last_revision replays the WAL attached to new_rt; replay
        # here only when ours is another object (or nothing was restored:
        # a WAL-only recovery still feeds the suffix again)
        if self.wal is not None and (
                revision is None
                or getattr(new_rt.app_context, "ingest_wal", None) is not self.wal):
            self.wal.replay(new_rt)
        for sr in getattr(new_rt, "source_runtimes", []):
            sr.resume()
        stat_count(new_rt.app_context, "resilience.peer_recoveries")
        if self.on_recovered is not None:
            self.on_recovered(new_rt, revision)
        return new_rt, revision


@guarded
class AppSupervisor:
    """Heartbeats one app's @Async junction workers and ingest packers
    and watches its pipeline. ``SiddhiAppRuntime.supervise()`` is the
    usual entry."""

    # the tick thread and producers' backpressure escalations (any sender
    # thread) both read-modify-write the beat table
    GUARDED_BY = {"_beat_seen": "app_supervisor"}

    def __init__(self, app_runtime, interval_s: float = 0.25,
                 wedge_timeout_s: float = 5.0,
                 peer_recovery: Optional[PeerRecovery] = None,
                 peer_monitor: Optional[PeerMonitor] = None):
        from siddhi_tpu_torch.core.stream.junction import _IDLE_POLL_S

        self.app_runtime = app_runtime
        self.peer_monitor = peer_monitor
        self.peer_recovery = peer_recovery
        self.recovery_result = None       # (new_runtime, revision)
        self._recovering = threading.Event()
        self._recovered = threading.Event()
        self.interval_s = float(interval_s)
        # below 3 idle polls an IDLE worker (which beats only when its
        # bounded queue wait times out) would look wedged
        self.wedge_timeout_s = max(float(wedge_timeout_s), 3.0 * _IDLE_POLL_S)
        self.worker_restarts = 0
        self.pump_wedges = 0              # pipeline stalls detected
        self._pump_wedge_flagged = False  # one count and log an episode
        self._beat_seen = {}              # junction id -> (beats, t_changed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = make_lock("app_supervisor")

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "AppSupervisor":
        if self._thread is not None:
            return self
        self.app_runtime.app_context.supervisor = self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"supervisor-{self.app_runtime.name}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        if self.peer_monitor is not None:
            self.peer_monitor.close()
        if getattr(self.app_runtime.app_context, "supervisor", None) is self:
            self.app_runtime.app_context.supervisor = None

    # --------------------------------------------------------- heartbeats

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception:                     # noqa: BLE001
                log.exception("supervisor tick failed")

    def _tick(self) -> None:
        from siddhi_tpu_torch.resilience import stat_count

        if self.peer_monitor is not None:
            from siddhi_tpu_torch.parallel.distributed import ClusterPeerError

            for addr in self.peer_monitor.poll_dead():
                self.notify_error(None, ClusterPeerError(
                    f"cluster peer {addr[0]}:{addr[1]} lost its heartbeat — "
                    f"presumed dead; restore from the last snapshot revision"))
        now = time.monotonic()
        for sid, j in list(self.app_runtime.junctions.items()):
            if not (j._async and j._running):
                continue
            # the beat table is shared with notify_backpressure: the
            # read-judge-restart sequence is one atom, or a concurrent
            # escalation restarts twice
            with self._lock:
                worker = j._worker
                beats = j._beats
                seen = self._beat_seen.get(sid)
                if seen is None or seen[0] != beats:
                    self._beat_seen[sid] = (beats, now)
                    stalled = False
                else:
                    stalled = (now - seen[1]) > self.wedge_timeout_s
                dead = worker is None or not worker.is_alive()
                if j._fatal is not None:
                    continue    # a framework failure reaches the senders:
                    #             it is not a restartable fault
                if not (dead or stalled):
                    continue
                log.warning("supervisor: restarting %s worker of junction '%s'",
                            "dead" if dead else "wedged", sid)
                j.restart_worker()
                self.worker_restarts += 1
                self._beat_seen[sid] = (j._beats, now)
            stat_count(self.app_runtime.app_context, "resilience.worker_restarts")
        # a dead packer's sub-batch was re-packed by the merging thread
        # (never lost); the tick respawns the thread so the pool's width
        # comes back without waiting for the next submit
        pool = self.app_runtime.app_context.ingest_pack_pool
        if pool is not None:
            healed = pool.heal()
            if healed:
                log.warning("supervisor: respawned %d dead ingest pack "
                            "worker(s)", healed)
                self.worker_restarts += healed
                stat_count(self.app_runtime.app_context,
                           "resilience.worker_restarts", healed)
        self._check_pump()

    def _check_pump(self) -> None:
        """A pump entry older than ``wedge_timeout_s``: its device step
        (or the graph replay behind it) has not finished. Counted once an
        episode; the entries stay with the pump, so a replacement worker
        drains them in order when they do finish."""
        from siddhi_tpu_torch.resilience import stat_count

        age = self.app_runtime.app_context.completion_pump.oldest_age_s()
        if age is not None and age > self.wedge_timeout_s:
            if not self._pump_wedge_flagged:
                self._pump_wedge_flagged = True
                self.pump_wedges += 1
                log.warning(
                    "supervisor: completion pump of app '%s' looks wedged: "
                    "its oldest in-flight batch is %.1fs old and its meta "
                    "has not arrived (a hung device step)",
                    self.app_runtime.name, age)
                stat_count(self.app_runtime.app_context, "resilience.pump_wedges")
        else:
            self._pump_wedge_flagged = False

    # ------------------------------------------------- producer backpressure

    def notify_backpressure(self, junction) -> bool:
        """A producer's bounded enqueue wait timed out: check that
        junction's worker now and replace it when dead or beat-stalled.
        True when a restart was issued; a healthy but slow worker is left
        alone (the wait was backpressure, not a wedge)."""
        from siddhi_tpu_torch.resilience import stat_count

        if not (junction._async and junction._running):
            return False
        if junction._fatal is not None:
            return False      # reaches the senders; not restartable
        sid = junction.definition.id
        with self._lock:
            now = time.monotonic()
            worker = junction._worker
            dead = worker is None or not worker.is_alive()
            seen = self._beat_seen.get(sid)
            if seen is None:
                # first sighting: a baseline, so the next timeout can tell
                # stalled from slow
                self._beat_seen[sid] = (junction._beats, now)
                stalled = False
            else:
                stalled = (seen[0] == junction._beats
                           and (now - seen[1]) > self.wedge_timeout_s)
            if not (dead or stalled):
                return False
            log.warning("supervisor: producer backpressure escalation — "
                        "restarting %s worker of junction '%s'",
                        "dead" if dead else "wedged", sid)
            junction.restart_worker()
            self.worker_restarts += 1
            self._beat_seen[sid] = (junction._beats, now)
        stat_count(self.app_runtime.app_context, "resilience.worker_restarts")
        return True

    # ------------------------------------------------------ peer recovery

    def notify_error(self, junction, error: Exception) -> None:
        """Called by ``StreamJunction.handle_error`` for every processing
        error; counts ``resilience.peer_failures`` for each peer failure
        and runs the recovery (once)."""
        from siddhi_tpu_torch.resilience import stat_count

        if not is_peer_failure(error):
            return
        stat_count(self.app_runtime.app_context, "resilience.peer_failures")
        if self.peer_recovery is None:
            return
        with self._lock:
            if self._recovering.is_set():
                return
            self._recovering.set()
        threading.Thread(target=self._recover, daemon=True,
                         name=f"peer-recovery-{self.app_runtime.name}").start()

    def _recover(self) -> None:
        try:
            self.recovery_result = self.peer_recovery.recover(
                old_runtime=self.app_runtime)
        except Exception:                         # noqa: BLE001
            log.exception("peer recovery failed")
        finally:
            self._recovered.set()

    def wait_recovered(self, timeout: Optional[float] = None):
        """Block until a triggered peer recovery finished; returns the
        ``(new_runtime, revision)`` result, or None."""
        self._recovered.wait(timeout)
        return self.recovery_result
