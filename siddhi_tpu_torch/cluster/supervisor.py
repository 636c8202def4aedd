"""Worker fleet supervisor: spawn, probe, respawn.

Counterpart of ``siddhi_tpu/cluster/supervisor.py``: the process half of
the fabric's effectively-once story. Each worker is a child ``python -m
siddhi_tpu_torch.cluster.worker`` process on the runtime's device; every
worker binds a ``PeerMonitor`` heartbeat listener
(``resilience/supervisor.py``) whose address it reports in its link
hello, and this supervisor probes them all each tick. A worker is
presumed dead when EITHER its process exits (``Popen.poll``) or its
listener refuses ``misses`` probes in a row (a wedged but live process);
a dead worker is killed outright, respawned, and its monitor entry
re-armed. The RECOVERY itself (re-deploy, restore, WAL replay, key-range
resume) is the router's (``router._recover_worker``) and runs when the
replacement dials back in; this module only guarantees there is always a
process to dial.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

from siddhi_tpu_torch.analysis.guards import guarded
from siddhi_tpu_torch.analysis.locks import make_lock


def _child_env() -> dict:
    """The parent's environment, with the package importable from any
    working directory (the tree is not pip-installed)."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parts = [root] + [p for p in env.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(parts)
    return env


@guarded
class WorkerSupervisor:
    """Owns the worker processes of one ``ClusterRuntime``."""

    GUARDED_BY = {
        "procs": "cluster_supervisor", "respawns": "cluster_supervisor",
        "_addrs": "cluster_supervisor", "_held_down": "cluster_supervisor",
    }

    def __init__(self, runtime, persist_root: Optional[str] = None,
                 heartbeat_s: float = 0.5, misses: int = 3,
                 interval_s: float = 0.25):
        from siddhi_tpu_torch.resilience.supervisor import PeerMonitor

        self.runtime = runtime
        self._own_root = persist_root is None
        self.persist_root = persist_root or tempfile.mkdtemp(
            prefix="siddhi-cluster-")
        self.heartbeat_s = float(heartbeat_s)
        self.interval_s = float(interval_s)
        self.monitor = PeerMonitor(probe_timeout_s=0.5, misses=misses)
        n = runtime.n_workers
        self.procs: List[Optional[subprocess.Popen]] = [None] * n
        self.respawns = [0] * n
        self._addrs: Dict[int, Tuple[str, int]] = {}
        self._held_down = set()      # killed on purpose, do not respawn
        self._lock = make_lock("cluster_supervisor")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "WorkerSupervisor":
        for idx in range(self.runtime.n_workers):
            self._spawn(idx)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="cluster-supervisor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        with self._lock:
            procs = list(self.procs)
        for proc in procs:
            if proc is not None and proc.poll() is None:
                proc.kill()
        for proc in procs:
            if proc is not None:
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
        self.monitor.close()
        if self._own_root:
            shutil.rmtree(self.persist_root, ignore_errors=True)

    # -------------------------------------------------------------- spawn

    def _spawn(self, idx: int) -> None:
        # the replacement binds a NEW heartbeat port; the old listener's
        # corpse must leave the monitor NOW or its death re-triggers
        # `worker_lost` against the fresh process
        with self._lock:
            old = self._addrs.pop(idx, None)
        if old is not None:
            self.monitor.unwatch(*old)
        store = os.path.join(self.persist_root, f"worker{idx}")
        os.makedirs(store, exist_ok=True)
        cmd = [sys.executable, "-m", "siddhi_tpu_torch.cluster.worker",
               "--connect", f"127.0.0.1:{self.runtime.port}",
               "--index", str(idx),
               "--persist-dir", store,
               "--device", str(self.runtime.device),
               "--heartbeat-s", str(self.heartbeat_s)]
        with self._lock:
            self.procs[idx] = subprocess.Popen(cmd, env=_child_env(),
                                               cwd=self.persist_root)

    # ------------------------------------------------- router notifications

    def worker_attached(self, idx: int) -> None:
        """Router callback: worker ``idx`` completed its hello (its
        heartbeat listener address is now known) — arm the probe."""
        hb_port = self.runtime.links[idx].hb_port
        if not hb_port:
            return
        addr = ("127.0.0.1", int(hb_port))
        with self._lock:
            old = self._addrs.get(idx)
            self._addrs[idx] = addr
        # monitor calls stay outside the lock: the PeerMonitor has its own
        # lock and this one must stay a leaf
        if old is not None and old != addr:
            self.monitor.unwatch(*old)
        self.monitor.rearm(*addr)

    def worker_lost(self, idx: int) -> None:
        """Router callback: link EOF or send failure. A live process
        behind a dead link is useless — kill it so the poll loop
        respawns one that can dial back in."""
        with self._lock:
            proc = self.procs[idx]
        if proc is not None and proc.poll() is None:
            proc.kill()

    # ------------------------------------------------------------- control

    def kill(self, idx: int, respawn: bool = True) -> None:
        """Hard-kill worker ``idx`` (a test's mid-feed kill). With
        ``respawn=False`` the corpse is held down until ``release``."""
        with self._lock:
            if not respawn:
                self._held_down.add(idx)
            proc = self.procs[idx]
        if proc is not None and proc.poll() is None:
            proc.kill()

    def release(self, idx: int) -> None:
        """Allow a held-down worker to respawn on the next tick."""
        with self._lock:
            self._held_down.discard(idx)

    def respawn_count(self, idx: int) -> int:
        with self._lock:
            return self.respawns[idx]

    # ---------------------------------------------------------- poll loop

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception as e:   # noqa: BLE001 — keep supervising
                print(f"[cluster-supervisor] tick failed: {e}",
                      flush=True)

    def _tick(self) -> None:
        # heartbeat-listener deaths: kill the (possibly wedged) process
        # so the exit check below owns the respawn decision
        dead_addrs = set(self.monitor.poll_dead())
        if dead_addrs:
            with self._lock:
                hit = [idx for idx, addr in self._addrs.items()
                       if addr in dead_addrs]
            for idx in hit:
                self.worker_lost(idx)
        for idx in range(self.runtime.n_workers):
            with self._lock:
                proc = self.procs[idx]
                held = idx in self._held_down
            if held or proc is None or proc.poll() is None:
                continue
            if self._stop.is_set():
                return
            with self._lock:
                self.respawns[idx] += 1
            self._spawn(idx)
