"""Resilience helpers the port's transports need.

Counterpart of the parts of ``siddhi_tpu/resilience/`` that sources and
sinks use: the shared backoff policy (``retry.RetryPolicy``) and
``stat_count``. The supervisor, the ingest WAL, fault injection and
overload control are not ported yet (ROADMAP A.10).
"""

from siddhi_tpu_torch.resilience.retry import RetryExhausted, RetryPolicy

__all__ = ["RetryExhausted", "RetryPolicy", "stat_count"]


def stat_count(app_context, name: str, n: int = 1) -> None:
    """Bump a recovery counter on the app's StatisticsManager; a no-op
    when statistics are not configured, as in the reference. The port has
    no StatisticsManager yet (ROADMAP A.10), so every call is that case."""
    sm = getattr(app_context, "statistics_manager", None)
    if sm is not None and getattr(sm, "level", 0) > 0:
        sm.count(name, n)
