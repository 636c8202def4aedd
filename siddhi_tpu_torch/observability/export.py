"""Metrics exposition: Prometheus text format + JSON snapshot.

Counterpart of ``siddhi_tpu/observability/export.py``. Renders every
deployed app's ``StatisticsManager`` (throughput, latency with
p50/p95/p99, named counters, DETAIL memory/buffer probes) and
``TelemetryRegistry`` (gauges, counters, histograms), merged with the
process-global registry, as:

- Prometheus text exposition (v0.0.4) for ``GET /metrics``;
- a JSON snapshot (``?format=json`` / ``Accept: application/json``).

Naming: structured label sets, not dotted metric names — per-query
latency is ``siddhi_latency_ms{app=...,name=...,quantile=...}``, and named
counters keep their dotted names as a LABEL VALUE
(``siddhi_counter_total{name="resilience.wal_replayed_batches"}``). The
well-known ``resilience.*`` counters are always emitted (0 until the event
happens) so dashboards and alerts can be written before the first failure.

The families the port has sources for: statistics, app and process
telemetry, the aggregation bucket gauges and fold histograms, the serving
tier's shard, WAL, pool, counter and latency families, the wire front
door's counters, fan-out fusion (``siddhi_fanout_group_size``,
``siddhi_fanout_dispatches_total``, ``siddhi_fanout_meta_pulls_total``),
the step records (``siddhi_jit_*``), the program cache
(``siddhi_program_cache_{hits,misses,evictions}_total`` and
``siddhi_program_cache_size``) and the step-program costs
(``siddhi_jit_cost_*{key}``); the ingest WAL's gauges, a fused stream's
``unique_programs`` and ``captured`` gauges and a query's ``captured``
gauge render as the generic ``siddhi_gauge``, as in the reference. The
reference's families of batch journeys, device instruments and the
autopilot (ROADMAP A.10),
the cluster fabric and the keyed-shard and join-partition gauges
(A.9/A.10) and the overload quotas (A.10) have no source in the port and
are not printed.
"""

from __future__ import annotations

import math
import re
import time
from typing import Dict, List, Tuple

from siddhi_tpu_torch.observability.telemetry import global_registry

# operationally load-bearing counters with a source in the port,
# pre-declared at 0 per app (the reference also declares the supervisor's,
# the cluster's and the overload layer's, ROADMAP A.10)
RESILIENCE_COUNTERS = (
    "resilience.wal_replayed_batches",
    "resilience.wal_dropped_batches",
    "resilience.source_retries",
    "resilience.sink_retries",
    # serving tier (siddhi_tpu_torch/serving/)
    "resilience.query_sheds",
    "resilience.shard_rebuilds",
    "resilience.shard_replay_skips",
    "resilience.shard_replay_gaps",
)

# the wire-format front door (POST /ingest/{stream}, service/rest.py)
_INGEST_COUNTER_FAMILY = {
    "ingest.wire.frames": ("siddhi_ingest_wire_frames_total",
                           "binary wire frames accepted on "
                           "POST /ingest/{stream}"),
    "ingest.wire.bytes": ("siddhi_ingest_wire_bytes_total",
                          "wire-frame bytes accepted on "
                          "POST /ingest/{stream}"),
    "ingest.wire.events": ("siddhi_ingest_wire_events_total",
                           "events ingested through the wire-format "
                           "front door"),
}

# serving tier (siddhi_tpu_torch/serving/): aggregation rollup + scatter-gather
_AGG_BUCKETS = re.compile(r"^aggregation\.(?P<agg>.+)\.(?P<dur>[a-z]+)"
                          r"\.buckets$")
_AGG_SHARDS = re.compile(r"^aggregation\.(?P<agg>.+)\.shards$")
_AGG_SHARD_WAL = re.compile(r"^aggregation\.(?P<agg>.+)\.shard"
                            r"(?P<shard>\d+)\.wal_batches$")
_AGG_FLUSH_HIST = re.compile(r"^aggregation\.(?P<agg>.+)\.flush_ms$")
_SERVING_QUERY_HIST = re.compile(r"^serving\.query\.(?P<dur>[a-z]+)_ms$")
_SERVING_COUNTER_FAMILY = {
    "serving.queries": ("siddhi_serving_queries_total",
                        "on-demand queries admitted by the serving tier"),
    "serving.sheds": ("siddhi_serving_shed_total",
                      "on-demand queries shed at the per-endpoint "
                      "admission cap (HTTP 503)"),
    "serving.shard_rebuilds": ("siddhi_serving_shard_rebuilds_total",
                               "aggregation shards rebuilt from "
                               "checkpoint blob + WAL suffix"),
}
# fan-out fusion (core/query/fused_fanout.py)
# the process-global program cache (core/util/program_cache.py): counters
# and the size gauge on the process registry
PROGRAM_CACHE_SIZE_FAMILY = "siddhi_program_cache_size"
_PROGRAM_CACHE_COUNTER_FAMILY = {
    "program_cache.hits": (
        "siddhi_program_cache_hits_total",
        "first-call program-cache hits: an equal step program (the "
        "witness: family, extra, device, columns, state, program, "
        "constants) was shared instead of built"),
    "program_cache.misses": (
        "siddhi_program_cache_misses_total",
        "first-call program-cache misses: no equal program was live, this "
        "step registered as the shared program"),
    "program_cache.evictions": (
        "siddhi_program_cache_evictions_total",
        "program-cache entries evicted (refcount zero, the "
        "program_cache_max cap, or a drain)"),
}
# the step-program cost registry (observability/costmodel.py): one gauge
# per (step key, metric) on the process registry
_JITCOST_GAUGE = re.compile(
    r"^jitcost\.(?P<key>.+)\.(?P<metric>flops|bytes_accessed|arg_bytes|"
    r"out_bytes|temp_bytes|code_bytes|compile_ms)$")
_JITCOST_HELP = {
    "flops": ("siddhi_jit_cost_flops",
              "aten-op output elements of one eager run of the step"),
    "bytes_accessed": ("siddhi_jit_cost_bytes_accessed",
                       "aten-op input and output bytes of one eager run"),
    "arg_bytes": ("siddhi_jit_cost_arg_bytes",
                  "step argument bytes (state and inputs)"),
    "out_bytes": ("siddhi_jit_cost_out_bytes", "step output bytes"),
    "temp_bytes": ("siddhi_jit_cost_temp_bytes",
                   "device bytes the run allocated beyond its outputs"),
    "code_bytes": ("siddhi_jit_cost_code_bytes",
                   "generated code bytes (0: the port compiles no program)"),
    "compile_ms": ("siddhi_jit_cost_compile_ms",
                   "wall ms of the capture's eager run"),
}
_FANOUT_GAUGE = re.compile(r"^fanout\.(?P<stream>.+)\.group_size$")
_FANOUT_COUNTER = re.compile(r"^fanout\.(?P<stream>.+)\.(?P<kind>"
                             r"dispatches|meta_pulls)$")
_SERVING_HIST_FAMILY = {
    "serving.fanout_ms": ("siddhi_serving_fanout_ms",
                          "scatter fan-out time across aggregation "
                          "shards (ms)"),
    "serving.merge_ms": ("siddhi_serving_merge_ms",
                         "ordered cross-shard rollup merge time (ms)"),
}

def _esc(v: str) -> str:
    """Label-VALUE escaping per the text-format spec: backslash, double
    quote, and line feed (stream/app/query names are user-controlled
    SiddhiQL identifiers — a hostile name must not break the sample
    grammar or inject bogus series)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _esc_help(v: str) -> str:
    """HELP-text escaping per the spec: backslash and line feed only
    (quotes are legal in HELP)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Families:
    """Accumulates samples grouped per metric family so each family's
    ``# TYPE`` header is emitted exactly once, before its samples."""

    def __init__(self):
        self._fam: Dict[str, Tuple[str, str, List[str]]] = {}

    def add(self, family: str, ftype: str, help_: str,
            labels: Dict[str, str], value, suffix: str = ""):
        rec = self._fam.get(family)
        if rec is None:
            rec = self._fam[family] = (ftype, help_, [])
        lbl = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
        lbl = "{" + lbl + "}" if lbl else ""
        rec[2].append(f"{family}{suffix}{lbl} {_fmt(value)}")

    def render(self) -> str:
        lines = []
        for family in sorted(self._fam):
            ftype, help_, samples = self._fam[family]
            lines.append(f"# HELP {family} {_esc_help(help_)}")
            lines.append(f"# TYPE {family} {ftype}")
            lines.extend(samples)
        return "\n".join(lines) + "\n"


def _add_histogram(fams: _Families, family: str, help_: str,
                   labels: Dict[str, str], snap: dict) -> None:
    """Render one telemetry histogram snapshot as a Prometheus summary
    (quantile samples + _sum/_count), matching the latency-tracker
    exposition shape."""
    for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
        fams.add(family, "summary", help_,
                 {**labels, "quantile": q}, snap.get(key, 0.0))
    fams.add(family, "summary", help_, labels, snap.get("sum", 0.0),
             suffix="_sum")
    fams.add(family, "summary", help_, labels, snap.get("count", 0),
             suffix="_count")


def app_snapshot(rt) -> dict:
    """JSON-ready metrics for one app runtime."""
    sm = rt.app_context.statistics_manager
    return {
        "app": rt.name,
        "statistics": rt.statistics() if sm is not None else {"level": "off"},
        "telemetry": rt.app_context.telemetry.snapshot(),
    }


def json_snapshot(manager) -> dict:
    t0 = time.perf_counter()
    try:
        return {
            "apps": {name: app_snapshot(rt)
                     for name, rt in sorted(manager.app_runtimes.items())},
            "process": global_registry().snapshot(),
        }
    finally:
        _record_scrape_ms(t0)


def _record_scrape_ms(t0: float) -> None:
    """Scrape self-timing (``siddhi_scrape_ms``): the duration lands in
    the process registry AFTER the snapshot is taken, so each scrape
    reports its predecessors — a scrape crossing its SLO is visible on
    the dashboard scraping it."""
    global_registry().histogram("scrape.ms").record(
        (time.perf_counter() - t0) * 1000.0)


def _add_telemetry(fams: _Families, tel_snapshot: dict, app: str):
    base = {"app": app} if app else {}
    for name, v in sorted(tel_snapshot.get("gauges", {}).items()):
        m = _AGG_SHARD_WAL.match(name)
        if m:
            fams.add("siddhi_aggregation_shard_wal_batches", "gauge",
                     "retained per-shard WAL batches (rebuild "
                     "replay suffix)",
                     {**base, "name": m.group("agg"),
                      "shard": m.group("shard")}, v)
            continue
        m = _AGG_SHARDS.match(name)
        if m:
            fams.add("siddhi_aggregation_shards", "gauge",
                     "in-process key shards of the aggregation "
                     "rollup state",
                     {**base, "name": m.group("agg")}, v)
            continue
        m = _AGG_BUCKETS.match(name)
        if m:
            fams.add("siddhi_aggregation_buckets", "gauge",
                     "live rollup buckets per granularity",
                     {**base, "name": m.group("agg"),
                      "duration": m.group("dur")}, v)
            continue
        if name == "program_cache.size":
            fams.add(PROGRAM_CACHE_SIZE_FAMILY, "gauge",
                     "live entries in the process-global program cache",
                     base, v)
            continue
        m = _JITCOST_GAUGE.match(name)
        if m:
            family, help_ = _JITCOST_HELP[m.group("metric")]
            fams.add(family, "gauge", help_, {**base, "key": m.group("key")}, v)
            continue
        m = _FANOUT_GAUGE.match(name)
        if m:
            fams.add("siddhi_fanout_group_size", "gauge",
                     "queries fused into one dispatch per stream batch",
                     {**base, "stream": m.group("stream")}, v)
            continue
        if name in ("serving.pool.pending", "serving.pool.active"):
            kind = name.rsplit(".", 1)[1]
            fams.add(f"siddhi_serving_pool_{kind}", "gauge",
                     ("on-demand queries admitted and not yet "
                      "finished" if kind == "pending"
                      else "on-demand queries currently executing"),
                     base, v)
            continue
        fams.add("siddhi_gauge", "gauge", "registered telemetry gauge",
                 {**base, "name": name}, v)
    for name, v in sorted(tel_snapshot.get("counters", {}).items()):
        fam = (_SERVING_COUNTER_FAMILY.get(name)
               or _INGEST_COUNTER_FAMILY.get(name)
               or _PROGRAM_CACHE_COUNTER_FAMILY.get(name))
        if fam is not None:
            fams.add(fam[0], "counter", fam[1], base, v)
            continue
        m = _FANOUT_COUNTER.match(name)
        if m:
            fams.add(f"siddhi_fanout_{m.group('kind')}_total", "counter",
                     ("fused fan-out device dispatches (one per group "
                      "per stream batch)"
                      if m.group("kind") == "dispatches"
                      else "fused fan-out combined __meta__ round trips"),
                     {**base, "stream": m.group("stream")}, v)
            continue
        fams.add("siddhi_counter_total", "counter",
                 "named event counter",
                 {**base, "name": name}, v)
    for name, snap in sorted(tel_snapshot.get("histograms", {}).items()):
        fam = _SERVING_HIST_FAMILY.get(name)
        labels = dict(base)
        if fam is not None:
            family, help_ = fam
        else:
            m = _AGG_FLUSH_HIST.match(name)
            if m:
                family = "siddhi_aggregation_flush_ms"
                help_ = "aggregation ingest fold latency per batch (ms)"
                labels["name"] = m.group("agg")
            elif name == "scrape.ms":
                family = "siddhi_scrape_ms"
                help_ = "/metrics scrape self-timing (ms)"
            else:
                m = _SERVING_QUERY_HIST.match(name)
                if m:
                    family = "siddhi_serving_query_ms"
                    help_ = ("on-demand store-query latency per "
                             "granularity (ms)")
                    labels["granularity"] = m.group("dur")
                else:
                    family = "siddhi_histogram_ms"
                    help_ = "registered telemetry histogram (ms)"
                    labels["name"] = name
        _add_histogram(fams, family, help_, labels, snap)
    for key, rec in sorted(tel_snapshot.get("jit", {}).items()):
        kl = {**base, "key": key}
        fams.add("siddhi_jit_compiles_total", "counter",
                 "jitted step functions compiled", kl, rec["compiles"])
        fams.add("siddhi_jit_compile_ms_total", "counter",
                 "wall-clock ms spent in first-call jit compiles", kl,
                 rec["compile_ms"])
        fams.add("siddhi_jit_cache_hits_total", "counter",
                 "jitted step cache hits", kl, rec["hits"])


def _add_statistics(fams: _Families, rt):
    app = rt.name
    sm = rt.app_context.statistics_manager
    report = rt.statistics() if sm is not None else {"level": "off"}
    fams.add("siddhi_statistics_level", "gauge",
             "statistics level (0=off 1=basic 2=detail)",
             {"app": app},
             {"off": 0, "basic": 1, "detail": 2}.get(report.get("level"), 0))
    for name, t in sorted(report.get("throughput", {}).items()):
        fams.add("siddhi_stream_events_total", "counter",
                 "events published through the stream junction",
                 {"app": app, "stream": name}, t["events"])
        fams.add("siddhi_stream_batches_total", "counter",
                 "batches published through the stream junction",
                 {"app": app, "stream": name}, t["batches"])
    for name, lat in sorted(report.get("latency", {}).items()):
        labels = {"app": app, "name": name}
        for q in ("0.5", "0.95", "0.99"):
            key = {"0.5": "p50_ms", "0.95": "p95_ms", "0.99": "p99_ms"}[q]
            fams.add("siddhi_latency_ms", "summary",
                     "per-stage batch processing latency (ms)",
                     {**labels, "quantile": q}, lat.get(key, 0.0))
        fams.add("siddhi_latency_ms", "summary",
                 "per-stage batch processing latency (ms)",
                 labels, lat.get("total_ms", 0.0), suffix="_sum")
        fams.add("siddhi_latency_ms", "summary",
                 "per-stage batch processing latency (ms)",
                 labels, lat["batches"], suffix="_count")
        fams.add("siddhi_latency_ms_max", "gauge",
                 "max batch processing latency (ms)",
                 labels, lat.get("max_ms", 0.0))
    counters = dict(report.get("counters", {}))
    for name in RESILIENCE_COUNTERS:
        counters.setdefault(name, 0)
    for name, v in sorted(counters.items()):
        fams.add("siddhi_counter_total", "counter", "named event counter",
                 {"app": app, "name": name}, v)
    for name, v in sorted(report.get("memory_bytes", {}).items()):
        fams.add("siddhi_state_memory_bytes", "gauge",
                 "dense state footprint (bytes)",
                 {"app": app, "name": name}, v)
    for name, v in sorted(report.get("buffered_events", {}).items()):
        fams.add("siddhi_buffered_events", "gauge",
                 "pending buffered events/batches",
                 {"app": app, "name": name}, v)


def prometheus_text(manager, app_name=None) -> str:
    """Prometheus text exposition for every app (or one app) plus the
    process-global telemetry. Scrape hygiene: this function takes no app
    barrier and makes no device pulls (every registered gauge is host-side
    — a busy app must never stall a scrape), and times itself into
    ``siddhi_scrape_ms``."""
    t0 = time.perf_counter()
    try:
        fams = _Families()
        runtimes = manager.app_runtimes
        if app_name is not None:
            rt = runtimes.get(app_name)
            if rt is None:
                raise KeyError(f"app '{app_name}' is not deployed")
            runtimes = {app_name: rt}
        for name in sorted(runtimes):
            rt = runtimes[name]
            _add_statistics(fams, rt)
            _add_telemetry(fams, rt.app_context.telemetry.snapshot(), name)
        _add_telemetry(fams, global_registry().snapshot(), "")
        return fams.render()
    finally:
        _record_scrape_ms(t0)
