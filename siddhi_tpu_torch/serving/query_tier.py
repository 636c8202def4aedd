"""Scatter-gather query tier: shared scatter pool + bounded admission.

Counterpart of ``siddhi_tpu/serving/query_tier.py``, whole.

Two thread pools with different jobs:

- **Scatter pool** (``scatter_pool()``): a small process-wide executor the
  sharded aggregation uses to read shard partials concurrently. Shared
  across apps and queries — per-runtime pools would leak a thread set per
  deployed app.
- **Admission pool** (``AdmissionPool``): the on-demand query executor in
  front of the REST surface. Bounded workers bound query *concurrency*;
  per-endpoint queue caps bound query *backlog*; past the cap,
  ``try_submit`` raises ``QueryShedError`` and the REST layer answers
  503 — a query storm degrades to fast rejections instead of stacking
  handler threads behind the app barrier and stalling ingest. Sheds and
  admissions are counted on the process telemetry registry
  (``serving.queries`` / ``serving.sheds`` → ``/metrics``) and, when the
  target app collects statistics, on its ``resilience.query_sheds``
  counter.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

from siddhi_tpu_torch.observability.telemetry import global_registry

_SCATTER_LOCK = threading.Lock()
_SCATTER_POOL: Optional[ThreadPoolExecutor] = None


def scatter_pool(max_workers: int = 16) -> ThreadPoolExecutor:
    """Lazy process-wide executor for per-shard partial reads. Lives for
    the process (idle workers cost nothing; shard reads are lock-bounded,
    never hanging); submits after interpreter shutdown raise
    RuntimeError, which callers handle by reading inline."""
    global _SCATTER_POOL
    with _SCATTER_LOCK:
        if _SCATTER_POOL is None:
            _SCATTER_POOL = ThreadPoolExecutor(
                max_workers=max_workers,
                thread_name_prefix="siddhi-scatter")
        return _SCATTER_POOL


class QueryShedError(RuntimeError):
    """Raised by ``AdmissionPool.try_submit`` when an endpoint's queue cap
    is reached — map to HTTP 503 (Retry-After) at the service edge."""

    def __init__(self, endpoint: str, cap: int):
        super().__init__(
            f"query load shed: '{endpoint}' has {cap} requests in flight "
            f"(per-endpoint queue cap; retry later or raise "
            f"query_queue_cap)")
        self.endpoint = endpoint
        self.cap = cap


class AdmissionPool:
    """Bounded query executor with per-endpoint admission control."""

    def __init__(self, max_workers: int = 8, default_cap: int = 64,
                 queue_caps: Optional[Dict[str, int]] = None,
                 telemetry=None):
        self._exec = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="siddhi-query")
        self.default_cap = int(default_cap)
        self.queue_caps = dict(queue_caps or {})
        self._lock = threading.Lock()
        self._pending: Dict[str, int] = {}   # submitted, not yet finished
        self._active = 0                     # currently executing
        self._tel = telemetry if telemetry is not None else global_registry()
        self._gauge_names = ("serving.pool.pending", "serving.pool.active")
        self._tel.gauge(self._gauge_names[0],
                        lambda: sum(self._pending.values()))
        self._tel.gauge(self._gauge_names[1], lambda: self._active)

    def cap_for(self, endpoint: str) -> int:
        return self.queue_caps.get(endpoint, self.default_cap)

    def try_submit(self, endpoint: str, fn, *args, cap=None,
                   **kwargs) -> Future:
        """Admit or shed: raises ``QueryShedError`` when the endpoint
        already has ``cap`` requests pending (queued + executing).
        ``cap`` overrides the endpoint's configured cap for this submit:
        the service edge (``service/rest.py``) passes an app's own
        ``query_cap`` here when the app registered one with the overload
        layer (``resilience/overload.py``), making admission per tenant:
        a ``/query:<app>`` endpoint tracks its own pending count, so one
        app's query storm sheds against its own cap instead of consuming
        the shared pool's."""
        if cap is None:
            cap = self.cap_for(endpoint)
        with self._lock:
            n = self._pending.get(endpoint, 0)
            if n >= cap:
                self._tel.count("serving.sheds")
                raise QueryShedError(endpoint, cap)
            self._pending[endpoint] = n + 1
        self._tel.count("serving.queries")

        def run():
            with self._lock:
                self._active += 1
            try:
                return fn(*args, **kwargs)
            finally:
                with self._lock:
                    self._active -= 1
                    self._pending[endpoint] -= 1

        try:
            return self._exec.submit(run)
        except RuntimeError:     # pool shut down mid-request
            with self._lock:
                self._pending[endpoint] -= 1
            raise

    def shutdown(self):
        # unregister the gauges: the registry is process-global, and a
        # dead pool's closures would otherwise be scraped (and pin the
        # pool) forever
        for name in self._gauge_names:
            self._tel.remove_gauge(name)
        self._exec.shutdown(wait=False)
