"""Observability: percentile histograms, telemetry and metrics export.

Counterpart of ``siddhi_tpu/observability/``, reduced to what the port
has sources for:

- ``histogram``: fixed-bucket log-spaced (HDR-style) latency histograms
  with p50/p95/p99, embedded in ``LatencyTracker``;
- ``telemetry``: gauges, counters and histograms, one registry per app
  plus a process-global one;
- ``export``: Prometheus text exposition and a JSON snapshot, served at
  ``GET /metrics[/{app}]`` on the REST service (``service/rest.py``);
- ``telemetry.InstrumentedJit``: the step instrument every step goes
  through (compile events, the program cache, cost capture);
- ``costmodel``: the step-program cost registry behind ``GET /programs``.

The span tracer (``tracing``), batch journeys (``journey``) and device
instruments (``instruments``) are ROADMAP A.10.
"""

from siddhi_tpu_torch.observability.histogram import Histogram
from siddhi_tpu_torch.observability.telemetry import (
    TelemetryRegistry,
    global_registry,
)

__all__ = ["Histogram", "TelemetryRegistry", "global_registry"]
