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
- ``costmodel``: the step-program cost registry behind ``GET /programs``;
- ``tracing``: structured host spans (compile, plan, jit, junction
  dispatch, query step, sink publish, persist), ring-buffered and
  exported as Chrome-trace JSON (``POST /trace/start|stop``);
- ``journey``: batch journeys through pack, queue, dispatch, device and
  emit, and the critical-path report (``GET /profile/critical_path``);
- ``instruments``: device instruments, lanes computed inside each step
  that ride the batch's one meta pull;
- ``device_trace``: the device profiler trace (``torch.profiler``) behind
  ``SiddhiAppRuntime.start_trace`` and ``POST /profile/device/*``.
"""

from siddhi_tpu_torch.observability.histogram import Histogram
from siddhi_tpu_torch.observability.telemetry import (
    TelemetryRegistry,
    global_registry,
)
from siddhi_tpu_torch.observability.tracing import TRACER, Tracer, span

__all__ = ["Histogram", "TRACER", "TelemetryRegistry", "Tracer",
           "global_registry", "span"]
