"""Resilience: retry, the ingest WAL, faults, overload and supervision.

Counterpart of ``siddhi_tpu/resilience/`` but for the cluster's peer
recovery: the backoff policy of sources and sinks (``retry.RetryPolicy``),
the bounded ingest replay log (``replay.IngestWAL``: recorded at the
``InputHandler``, trimmed at every checkpoint, replayed after
``restore_revision``; the serving tier's per-shard logs), deterministic
fault injection (``faults.FaultInjector``: kill, wedge or delay a
junction worker or an ingest packer, fail sink publishes, flood a
stream, plant a journey-stage delay), overload control
(``overload``: per-app queue quotas with the shed policies block,
shed_oldest and shed_newest, the pipeline quota, the device-memory budget
of every capacity-growth site, weighted fair scheduling), the app
supervisor (``supervisor.AppSupervisor``: worker heartbeats and
restarts, dead packers healed, the pipeline's wedge check), the
peer liveness listener (``supervisor.PeerMonitor``, which the cluster
fabric's worker supervisor probes), the peer-death recovery of a
multi-process cluster (``supervisor.PeerRecovery``) and ``stat_count``.
"""

from siddhi_tpu_torch.resilience.faults import FaultInjector, WorkerKilled
from siddhi_tpu_torch.resilience.overload import (
    AppOverloadControl,
    OverloadConfig,
    OverloadManager,
)
from siddhi_tpu_torch.resilience.replay import IngestWAL, register_wal_gauges
from siddhi_tpu_torch.resilience.retry import RetryExhausted, RetryPolicy
from siddhi_tpu_torch.resilience.supervisor import (
    AppSupervisor, PeerMonitor, PeerRecovery)

__all__ = ["AppOverloadControl", "AppSupervisor", "FaultInjector", "IngestWAL",
           "OverloadConfig", "OverloadManager", "PeerMonitor", "PeerRecovery",
           "RetryExhausted", "RetryPolicy", "WorkerKilled", "register_wal_gauges",
           "stat_count"]


def stat_count(app_context, name: str, n: int = 1) -> None:
    """Bump a recovery counter on the app's StatisticsManager (a no-op
    when statistics are not configured). Resilience events are rare and
    operationally load-bearing, so they count at every level above OFF."""
    sm = getattr(app_context, "statistics_manager", None)
    if sm is not None and getattr(sm, "level", 0) > 0:
        sm.count(name, n)
