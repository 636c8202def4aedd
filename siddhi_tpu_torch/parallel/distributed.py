"""Multi-process initialization: the process-group half of the comm backend.

Counterpart of ``siddhi_tpu/parallel/distributed.py``. The reference joins
its hosts with ``jax.distributed``; the port joins its processes with
``torch.distributed``: every process runs the same program on the same
events (the multi-controller contract), ``initialize_cluster`` joins them
into one process group, and ``global_mesh`` spans every process's shards.
The key-sharded and routed steps of ``parallel/mesh.py`` then split keyed
state over the processes and move rows and outputs with the group's
collectives (``all_to_all_single``, ``all_gather``): NCCL between cards,
gloo between CPU processes.

Usage (the same program in every process)::

    from siddhi_tpu_torch.parallel.distributed import (
        global_mesh, initialize_cluster)
    initialize_cluster("host0:8476", num_processes=4, process_id=RANK)
    shard_query_step(runtime, global_mesh())

Nothing here initializes CUDA or builds anything when the module is
imported.
"""

from __future__ import annotations

from typing import Optional

from siddhi_tpu_torch.parallel.mesh import Mesh

# jax.distributed's defaults, which the reference keeps: a heartbeat every
# 10 s, and a peer declared dead after 10 missed heartbeats
_HEARTBEAT_S = 10.0
_DEFAULT_MISSING_HEARTBEATS = 10

# the group's device (a process's one card, or the CPU), set by
# initialize_cluster; None before it (global_mesh then takes the caller's)
_group_device = None
# the group's timeout in seconds, set by initialize_cluster
_group_timeout_s = None


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       max_missing_heartbeats: Optional[int] = None,
                       backend: Optional[str] = None,
                       device=None) -> None:
    """Join this process into the cluster (``torch.distributed.
    init_process_group`` at ``tcp://{coordinator_address}``; with no
    address, the ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
    environment, ``env://``).

    ``device`` is this process's device: None means its CUDA card (the
    current one), ``"cpu"`` the CPU. The backend follows it, ``nccl`` for a
    card and ``gloo`` for the CPU; a card with no NCCL in this torch is an
    error, never a quiet fall back to gloo.

    ``max_missing_heartbeats`` (default: jax's 10 x 10 s, as in the
    reference) maps to the group's ``timeout``: ``max_missing_heartbeats *
    10 s``, the time a collective waits on a silent peer before the group
    declares it dead and fails the call. A supervised deployment
    (``resilience/supervisor.py``) that wants to recover in place should
    raise it: the supervisor's peer monitor and the bounded pull
    (``guarded_pull``, ``siddhi_tpu.cluster_step_timeout``) detect a dead
    peer much sooner."""
    import datetime

    import torch
    import torch.distributed as dist

    global _group_device, _group_timeout_s
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_cluster: the default device is this process's "
                "CUDA card and none is available; pass device=\"cpu\" to "
                "join a gloo group on the CPU")
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("initialize_cluster: the nccl backend needs a "
                             f"CUDA device, got {dev}")
        if not dist.is_nccl_available():
            raise RuntimeError(
                "initialize_cluster: NCCL is not built into this torch, and "
                "a CUDA process group needs it")
        torch.cuda.set_device(dev)
    missing = (_DEFAULT_MISSING_HEARTBEATS if max_missing_heartbeats is None
               else int(max_missing_heartbeats))
    timeout = datetime.timedelta(seconds=_HEARTBEAT_S * missing)
    init = (f"tcp://{coordinator_address}" if coordinator_address is not None
            else "env://")
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend=backend, init_method=init,
                            timeout=timeout, **kwargs)
    _group_device = dev
    _group_timeout_s = timeout.total_seconds()


def shutdown_cluster() -> None:
    """Leave the process group (``destroy_process_group``); a no-op when
    this process is in none."""
    import torch.distributed as dist

    global _group_device, _group_timeout_s
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _group_device = None
    _group_timeout_s = None


def group_timeout_s() -> float:
    """The seconds a collective of the group waits on a silent peer
    (``initialize_cluster``'s ``max_missing_heartbeats`` x 10 s; torch's
    default for a group made elsewhere): the bound of a device wait on a
    peer when the app sets no ``cluster_step_timeout``."""
    if _group_timeout_s is not None:
        return _group_timeout_s
    from torch.distributed.constants import default_pg_timeout

    return default_pg_timeout.total_seconds()


def _world() -> tuple:
    """(process_count, process_index): (1, 0) outside a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(local_shards: int = 1, device=None) -> Mesh:
    """The mesh over every process: ``process_count * local_shards``
    shards, process ``p`` owning global shards ``[p * L, (p + 1) * L)``
    on its own device (the group's, or ``device``)."""
    count, index = _world()
    local = int(local_shards)
    if local < 1:
        raise ValueError(f"global_mesh: need at least one local shard, got {local}")
    dev = device if device is not None else _group_device
    return Mesh(count * local, None if dev is None else _as_device(dev),
                process_count=count, process_index=index)


def local_survivor_mesh(local_shards: int = 1, device=None) -> Mesh:
    """The mesh over THIS process only: the shape a survivor rebuilds on
    after a peer death, when re-forming the full cluster is not (yet)
    possible. State restored from a snapshot (canonical, whole on every
    process) lays itself out on it."""
    dev = device if device is not None else _group_device
    return Mesh(int(local_shards), None if dev is None else _as_device(dev))


def _as_device(dev):
    import torch

    return torch.device(dev)


def process_info() -> dict:
    """The reference's four keys. Every process drives one device (its
    card, or the CPU), so ``local_devices`` is 1 and ``global_devices``
    the process count."""
    count, index = _world()
    return {
        "process_index": index,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }


class ClusterPeerError(RuntimeError):
    """A multi-process pull did not complete within the configured
    timeout — a peer process is presumed dead or unreachable.

    The reference surfaces transport failures through source retry /
    OnError hooks (``stream/input/source/Source.java:155-185``); the
    multi-process failure mode is different: a peer dying mid-collective
    leaves every other process BLOCKED inside the collective, so the
    detection has to be a bounded wait around the device pull. Raised
    inside the junction's delivery path, this error rides the same
    ``@OnError`` / fault-stream machinery as any other processing failure.

    TERMINAL for the runtime: the timed-out pull leaves a leaked thread
    parked on the device stream, so retrying (or stepping the runtime
    again) only stacks more leaked threads — ``guarded_pull`` counts
    them (``cluster.outstanding_pulls`` gauge) and fails fast at its
    cap. Recovery story: tear the runtime down, restart the cluster with
    the surviving processes (a new process group), and
    ``restore_last_revision()`` from the persistence store — snapshots
    are host-side and whole on every process, so any survivor can
    restore."""


# Fault-injection slot (resilience/faults.py): when set, every
# guarded_pull consults it BEFORE waiting — ``FaultInjector.drop_peer``
# installs a hook that raises ClusterPeerError at once, simulating a dead
# peer without waiting out the pull timeout. Never set in production.
_fault_hook = None

# Leaked-pull accounting: every timeout abandons a daemon thread parked in
# a wait that cannot be cancelled. The count of still-outstanding pulls is
# a process gauge (``cluster.outstanding_pulls`` on GET /metrics), capped
# by ``_MAX_OUTSTANDING_PULLS``: reaching the cap means the caller kept
# stepping a runtime that ClusterPeerError already declared dead, and
# further pulls fail fast instead of stacking threads.
_MAX_OUTSTANDING_PULLS = 32
_outstanding_pulls = 0
_pull_lock = None    # made at the first pull


def outstanding_pulls() -> int:
    """Pulls in flight or abandoned but still parked (the leaked waits of
    timed-out ``guarded_pull`` calls)."""
    return _outstanding_pulls


def _register_pull_gauge():
    from siddhi_tpu_torch.observability.telemetry import global_registry

    global_registry().gauge("cluster.outstanding_pulls", outstanding_pulls)


_register_pull_gauge()


def _read(value):
    """A tensor (or a list of them) as numpy: one host copy each."""
    import numpy as np
    import torch

    if isinstance(value, (list, tuple)):
        return [_read(v) for v in value]
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def guarded_pull(value, timeout_s: float, what: str = "cluster step",
                 wait=None):
    """``value`` (a tensor, or a list of tensors) read to numpy, bounded by
    ``timeout_s``. ``wait`` (optional) runs first in the same bounded
    thread: the pump hands its entries' event waits here, so the wait for
    a pinned meta's copy is bounded too.

    The read runs in a daemon thread; on timeout the caller gets a labeled
    ``ClusterPeerError`` at once (the stuck wait stays parked in the
    abandoned thread — a device wait cannot be cancelled, but the PROGRAM
    regains control, which is the part that matters for failure
    detection).

    ``ClusterPeerError`` is TERMINAL for the runtime that raised it: the
    abandoned thread still owns the device stream, so retrying the pull
    (or stepping the same runtime again) can only stack more leaked
    threads behind a dead collective. The supported recovery is the
    supervisor's peer protocol — abandon the runtime, rebuild on
    ``local_survivor_mesh()``, restore the last revision, replay the WAL
    (``resilience/supervisor.py``). Outstanding pulls are counted on the
    ``cluster.outstanding_pulls`` gauge and capped at
    ``_MAX_OUTSTANDING_PULLS``; at the cap, guarded_pull fails fast.

    A sanctioned pull site: its reads run inside
    ``analysis.sanitize.allowed_pull()``."""
    import threading

    global _pull_lock, _outstanding_pulls
    if _pull_lock is None:
        _pull_lock = threading.Lock()

    if _fault_hook is not None:
        _fault_hook(what)

    with _pull_lock:
        if _outstanding_pulls >= _MAX_OUTSTANDING_PULLS:
            raise ClusterPeerError(
                f"{what}: {_outstanding_pulls} device pulls already "
                f"outstanding (cap {_MAX_OUTSTANDING_PULLS}) — earlier "
                f"ClusterPeerErrors were terminal; abandon this runtime "
                f"and run the peer-recovery protocol instead of retrying")
        _outstanding_pulls += 1

    box = {}
    done = threading.Event()

    def pull():
        global _outstanding_pulls
        from siddhi_tpu_torch.analysis.sanitize import allowed_pull

        try:
            with allowed_pull():
                if wait is not None:
                    wait()
                box["v"] = _read(value)
        except Exception as ex:  # noqa: BLE001 — surfaced to the caller below
            box["e"] = ex
        finally:
            with _pull_lock:
                _outstanding_pulls -= 1
            done.set()

    t = threading.Thread(target=pull, daemon=True, name="siddhi-cluster-pull")
    t.start()
    if not done.wait(timeout_s):
        raise ClusterPeerError(
            f"{what} did not complete within {timeout_s:.1f}s — a cluster "
            f"peer process is presumed dead; this error is terminal for "
            f"the runtime: abandon it, restart the cluster and restore "
            f"from the last snapshot revision")
    if "e" in box:
        raise box["e"]
    return box["v"]
