"""Resilience: retry, the ingest WAL, fault injection and ``stat_count``.

Counterpart of the parts of ``siddhi_tpu/resilience/`` the port runs:
the backoff policy of sources and sinks (``retry.RetryPolicy``), the
bounded ingest replay log (``replay.IngestWAL``: recorded at the
``InputHandler``, trimmed at every checkpoint, replayed after
``restore_revision``; the serving tier's per-shard logs), deterministic
fault injection (``faults.FaultInjector``: kill, wedge or delay a
junction worker or an ingest packer, fail sink publishes, flood a
stream, plant a journey-stage delay) and ``stat_count``. The supervisor
and overload control are ROADMAP A.10 (b).
"""

from siddhi_tpu_torch.resilience.faults import FaultInjector, WorkerKilled
from siddhi_tpu_torch.resilience.replay import IngestWAL, register_wal_gauges
from siddhi_tpu_torch.resilience.retry import RetryExhausted, RetryPolicy

__all__ = ["FaultInjector", "IngestWAL", "RetryExhausted", "RetryPolicy",
           "WorkerKilled", "register_wal_gauges", "stat_count"]


def stat_count(app_context, name: str, n: int = 1) -> None:
    """Bump a recovery counter on the app's StatisticsManager (a no-op
    when statistics are not configured). Resilience events are rare and
    operationally load-bearing, so they count at every level above OFF."""
    sm = getattr(app_context, "statistics_manager", None)
    if sm is not None and getattr(sm, "level", 0) > 0:
        sm.count(name, n)
