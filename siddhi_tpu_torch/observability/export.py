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
the ingest pack pool (``siddhi_ingest_pool_{queue_depth,workers,
utilization}``), the step records (``siddhi_jit_*``), the program cache
(``siddhi_program_cache_{hits,misses,evictions}_total`` and
``siddhi_program_cache_size``) and the step-program costs
(``siddhi_jit_cost_*{key}``), the @Async junctions
(``siddhi_junction_{queue_depth,inflight_batches}``,
``siddhi_junction_{backpressure_stalls,enqueue_timeouts,shed_events}_total``),
the overload quotas (``siddhi_quota_utilization{resource[,stream]}``), the
build-time eligibility census
(``siddhi_eligibility_total{surface,code,query}``), the
dispatch pipeline (``siddhi_pipeline_depth{query}``,
``siddhi_pipeline_{stalls,metas,meta_pulls}_total``), the join engine
(``siddhi_join_partition_rows``, ``siddhi_join_{probe,insert}_ms``), the
batch journeys (``siddhi_stage_ms``, ``siddhi_stage_queue_ms``) and the
device instruments (``siddhi_device_instrument{,_capacity,_value}``); the
ingest WAL's gauges, a fused stream's ``unique_programs`` and
``captured`` gauges and a query's ``captured`` gauge render as the
generic ``siddhi_gauge``, as in the reference. The resilience counters
of the supervisor and the overload layer (worker restarts, pump wedges,
sheds, quota denials, enqueue timeouts) are declared at 0 for every app.
The autopilot (``autopilot/``) renders ``siddhi_autopilot_mode``,
``siddhi_autopilot_{ticks,freezes}_total`` and
``siddhi_autopilot_decisions_total{knob,direction,reason}``; the cluster
fabric's router (``cluster/router.py``, on the process registry) renders
``siddhi_cluster_workers_live``, ``siddhi_cluster_worker_{acked_seq,
wal_batches}{worker}``, the per-worker respawn, replay, gap and link-drop
counters and the ingest, run, egress, checkpoint and query counters; each
family prints once its source exists. The keyed-shard families of the
routed step (``parallel/mesh.py``) render as the reference renders them:
``siddhi_shard_rows{query,shard}`` and ``siddhi_shard_exchange_ms{query}``;
the peer counters of the app supervisor (``resilience.peer_failures``,
``resilience.peer_recoveries``) are declared at 0 for every app, and the
bounded pull's ``cluster.outstanding_pulls`` is a process gauge.
"""

from __future__ import annotations

import math
import re
import time
from typing import Dict, List, Tuple

from siddhi_tpu_torch.observability.telemetry import global_registry

# --- graftlint R3 declarations (metric-registration parity) ----------
# Every dotted telemetry name registered anywhere in the port
# (.gauge/.count/.histogram/stat_count) must start with one of these
# prefixes; each prefix maps to a dedicated family below or renders as
# the labeled generic siddhi_counter_total/siddhi_gauge on purpose. A
# registration with an undeclared prefix, and a declared prefix with no
# registration site left, are both lint findings. "query" is the port's
# own (a query's captured gauge).
TELEMETRY_PREFIXES = (
    "junction",      # @Async queue depth / stalls / sheds / timeouts
    "fanout",        # fused fan-out group size, dispatches, captured
    "pipeline",      # CompletionPump depth + metas/pulls/stalls
    "aggregation",   # rollup buckets, shards, shard WALs, flush_ms
    "shard",         # routed-row skew gauges + exchange_ms
    "join",          # device-join partition occupancy, probe/insert_ms
    "serving",       # admission pool, scatter-gather latency
    "quota",         # overload quota-utilization gauges
    "overload",      # always-on overload counters (generic family)
    "wal",           # ingest-WAL size gauges (generic siddhi_gauge)
    "cluster",       # the cluster fabric's router (process registry ->
                     # siddhi_cluster_*) and the bounded pull's
                     # outstanding_pulls gauge (parallel/distributed.py)
    "resilience",    # StatisticsManager recovery counters (stat_count)
    "stage",         # batch-journey per-stage service/queue histograms
                     # (observability/journey.py -> siddhi_stage_*)
    "jitcost",       # step-program cost gauges (observability/
                     # costmodel.py -> siddhi_jit_cost_*)
    "program_cache", # process-global program cache: hit/miss/eviction
                     # counters + live-entry size gauge
    "scrape",        # /metrics self-timing (siddhi_scrape_ms)
    "device",        # device-instrument slots riding the meta vector
                     # (observability/instruments.py -> siddhi_device_*)
    "ingest",        # pack-pool gauges and wire-frame counters
                     # (core/stream/input/pack_pool.py, service/rest.py
                     # -> siddhi_ingest_*)
    "eligibility",   # build-time eligibility census counters
                     # (core/eligibility.py -> siddhi_eligibility_total)
    "autopilot",     # controller mode gauge, tick/freeze and decision
                     # counters (autopilot/ -> siddhi_autopilot_*)
    "query",         # a query's captured gauge (generic siddhi_gauge)
)
# Gauge templates that live exactly as long as their registry does: each
# is on an app's TelemetryRegistry and dies with it at shutdown. Every
# other gauge must have a remove_gauge site, or a dissolved owner pins a
# dead probe on /metrics (the lint names this list on violation).
PROCESS_LIFETIME_GAUGES = (
    "junction.*",             # junctions live with the app
    "pipeline.*.inflight",    # label-keyed, survives rebuilds
    "wal.*",                  # registered at WAL attach
    "aggregation.*",          # both rollup paths register
    "quota.*",                # overload registration
    "join.partition_rows.*",  # device-join attach
    "shard.rows.*",           # the routed step's skew gauges (app registry)
    "cluster.outstanding_pulls",  # process registry, process-lifetime
    "device.*",               # instrument last-value and capacity gauges
    "query.*.captured",       # a query's step, rebuilt in place
)

# the data slots a step may declare in its instrument spec
# (observability/instruments.Slot); the exposition regexes below are built
# from this tuple
DEVICE_SLOTS = (
    "win_fill",        # window ring live rows (keyed: the hottest key)
    "groups",          # distinct group keys among the batch's rows
    "nfa_runs",        # live NFA partial-match slots
    "shard_rows",      # rows routed to each shard (the routed exchange)
    "route_residual",  # receive capacity left on the fullest shard
    "fill.left",       # join directory fill per partition
    "fill.right",
)
# structural (kind='check') slots: consumed at drain by a runtime's
# _consume_check_slot, never rendered as telemetry
DEVICE_CHECK_SLOTS = (
    "route_overflow",  # exchange overflow -> FatalQueryError
    "seq",             # the join's cross-stream sequence check
)

# operationally load-bearing counters with a source in the port,
# pre-declared at 0 per app
RESILIENCE_COUNTERS = (
    # the app supervisor (resilience/supervisor.py)
    "resilience.worker_restarts",
    "resilience.pump_wedges",
    "resilience.wal_replayed_batches",
    "resilience.wal_dropped_batches",
    "resilience.source_retries",
    "resilience.sink_retries",
    "resilience.peer_failures",
    "resilience.peer_recoveries",
    # serving tier (siddhi_tpu_torch/serving/)
    "resilience.query_sheds",
    "resilience.shard_rebuilds",
    "resilience.shard_replay_skips",
    "resilience.shard_replay_gaps",
    # overload control (resilience/overload.py)
    "resilience.shed_events",
    "resilience.quota_denials",
    "resilience.enqueue_timeouts",
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
# the routed step (parallel/mesh.py): per-shard routed-row gauges and the
# host's routing prep histogram, scope = the query
_SHARD_ROWS = re.compile(r"^shard\.rows\.(?P<scope>.+)\.(?P<shard>\d+)$")
_SHARD_EXCHANGE_HIST = re.compile(r"^shard\.exchange_ms\.(?P<scope>.+)$")
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
# families a check of the rendered text names (chip_smoke.py): one
# declaration each, read by the renderer below
AGGREGATION_SHARDS_FAMILY = "siddhi_aggregation_shards"
DEVICE_INSTRUMENT_FAMILY = "siddhi_device_instrument"
STAGE_MS_FAMILY = "siddhi_stage_ms"
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
_JUNCTION_GAUGE = re.compile(r"^junction\.(?P<stream>.+)\.(?P<kind>"
                             r"queue_depth|inflight_batches)$")
_JUNCTION_COUNTER = re.compile(r"^junction\.(?P<stream>.+)\.(?P<kind>"
                               r"backpressure_stalls|enqueue_timeouts|"
                               r"shed_events)$")
_JUNCTION_COUNTER_HELP = {
    "backpressure_stalls": "producer sends that blocked on a full @Async queue",
    "enqueue_timeouts": "bounded enqueue waits on a full @Async queue that "
                        "timed out and escalated to the supervisor",
    "shed_events": "events shed by overload admission (shed_oldest / "
                   "shed_newest past the queue quota)",
}
# overload control (resilience/overload.py): per-app quota utilization
_QUOTA_GAUGE = re.compile(r"^quota\.(?P<resource>queue|pipeline|memory)"
                          r"_utilization(?:\.(?P<stream>.+))?$")
_PIPELINE_GAUGE = re.compile(r"^pipeline\.(?P<query>.+)\.inflight$")
# eligibility.<surface>.<CODE>.<query>: surface spellings are the
# core/eligibility.py SURFACES tuple, codes its ReasonCode values
_ELIGIBILITY_COUNTER = re.compile(
    r"^eligibility\.(?P<surface>[a-z_]+)\.(?P<code>[A-Z0-9_]+)\.(?P<query>.+)$")
# the ingest pack pool (core/stream/input/pack_pool.py)
_INGEST_POOL_GAUGE = re.compile(r"^ingest\.pool\.(?P<kind>queue_depth|workers|"
                                r"utilization)$")
_INGEST_POOL_HELP = {"queue_depth": "sub-batch tasks queued on the ingest pack pool",
                     "workers": "live ingest pack-pool worker threads",
                     "utilization": "fraction of ingest pack workers busy"}
# pipeline.metas / pipeline.pulls: metas-per-pull batching ratio;
# pipeline.stalls: forced drains that had to wait on the card
_PIPELINE_COUNTER_FAMILY = {
    "pipeline.stalls": ("siddhi_pipeline_stalls_total",
                        "pipeline drains that blocked on a batch the card "
                        "had not finished"),
    "pipeline.metas": ("siddhi_pipeline_metas_total",
                       "batch metas drained through the dispatch pipeline "
                       "(divide by pulls for the batching ratio)"),
    "pipeline.pulls": ("siddhi_pipeline_meta_pulls_total",
                       "drain rounds of the dispatch pipeline"),
}
# the join engine (core/join/): per-partition directory occupancy gauges
# and the per-query probe and insert host-latency histograms
_JOIN_PART_ROWS = re.compile(r"^join\.partition_rows\.(?P<query>.+)"
                             r"\.(?P<side>left|right)\.(?P<part>\d+)$")
_JOIN_HIST = re.compile(r"^join\.(?P<kind>probe|insert)_ms\.(?P<query>.+)$")
# batch journeys (observability/journey.py): per-query per-stage service
# and queueing histograms
_STAGE_HIST = re.compile(r"^stage\.(?P<query>.+)\.(?P<stage>[a-z_]+)"
                         r"\.(?P<kind>service|queue)_ms$")
# device instruments (observability/instruments.py): per-query last value
# and capacity gauges and per-batch value histograms, the slot anchored to
# DEVICE_SLOTS (a query name may hold dots: the slot tail is fixed)
_DEVICE_SLOT_RX = "|".join(
    re.escape(x) for x in sorted(DEVICE_SLOTS, key=len, reverse=True))
_DEVICE_GAUGE = re.compile(r"^device\.(?P<query>.+)\.(?P<slot>" + _DEVICE_SLOT_RX
                           + r")(?P<cap>\.capacity)?$")
_DEVICE_HIST = re.compile(r"^device\.(?P<query>.+)\.(?P<slot>" + _DEVICE_SLOT_RX
                          + r")$")
_FANOUT_GAUGE = re.compile(r"^fanout\.(?P<stream>.+)\.group_size$")
_FANOUT_COUNTER = re.compile(r"^fanout\.(?P<stream>.+)\.(?P<kind>"
                             r"dispatches|meta_pulls)$")
# the autopilot (autopilot/): decision counters are dotted
# autopilot.decisions.<knob>.<direction>.<rule>, whose segments are
# code-controlled [a-z0-9_] identifiers, so the dotted split is unambiguous
_AUTOPILOT_DECISION = re.compile(
    r"^autopilot\.decisions\.(?P<knob>[a-z0-9_]+)"
    r"\.(?P<direction>up|down)\.(?P<reason>[a-z0-9_]+)$")
_AUTOPILOT_COUNTER_FAMILY = {
    "autopilot.ticks": ("siddhi_autopilot_ticks_total",
                        "autopilot observe/decide cycles run"),
    "autopilot.freezes": ("siddhi_autopilot_freezes_total",
                          "autopilot ticks skipped by compile-storm backoff "
                          "(step builds and graph captures still climbing)"),
}
# the cluster fabric (cluster/): the router's gauges live as long as its
# ClusterRuntime; a per-worker name carries the worker index as a label
_CLUSTER_WORKER_GAUGE = re.compile(
    r"^cluster\.worker\.(?P<kind>acked_seq|wal_batches)\.(?P<worker>\d+)$")
_CLUSTER_WORKER_COUNTER = re.compile(
    r"^cluster\.worker\.(?P<kind>respawns|replayed_batches|replay_gaps|"
    r"link_drops)\.(?P<worker>\d+)$")
_CLUSTER_WORKER_GAUGE_HELP = {
    "acked_seq": ("siddhi_cluster_worker_acked_seq",
                  "highest global ingest sequence the worker has acked"),
    "wal_batches": ("siddhi_cluster_worker_wal_batches",
                    "retained router-side ingest-WAL batches for the worker "
                    "(replay suffix; trimmed at checkpoint cuts)"),
}
_CLUSTER_WORKER_COUNTER_HELP = {
    "respawns": ("siddhi_cluster_worker_respawns_total",
                 "worker processes respawned after peer-death detection"),
    "replayed_batches": ("siddhi_cluster_worker_replayed_batches_total",
                         "WAL batches replayed into a recovered worker"),
    "replay_gaps": ("siddhi_cluster_worker_replay_gaps_total",
                    "runs unrecoverable at replay (WAL overflow), released "
                    "as counted gaps, never silent hangs"),
    "link_drops": ("siddhi_cluster_worker_link_drops_total",
                   "worker link sessions dropped (EOF/error on the "
                   "router-worker socket)"),
}
_CLUSTER_COUNTER_FAMILY = {
    "cluster.ingest_batches": ("siddhi_cluster_ingest_batches_total",
                               "batches sequenced by the router ingest front "
                               "door"),
    "cluster.ingest_rows": ("siddhi_cluster_ingest_rows_total",
                            "rows sequenced by the router ingest front door"),
    "cluster.runs_sent": ("siddhi_cluster_runs_sent_total",
                          "contiguous same-owner runs relayed to workers"),
    "cluster.runs_acked": ("siddhi_cluster_runs_acked_total",
                           "runs completed (seq-acked) by workers and merged "
                           "in global order"),
    "cluster.egress_rows": ("siddhi_cluster_egress_rows_total",
                            "output rows re-merged into exact global order by "
                            "the egress stitch"),
    "cluster.duplicate_emits_dropped": (
        "siddhi_cluster_duplicate_emits_dropped_total",
        "replayed emissions for already-merged runs dropped at the egress "
        "(the effectively-once dedup)"),
    "cluster.checkpoints": ("siddhi_cluster_checkpoints_total",
                            "cluster-wide checkpoint barriers completed"),
    "cluster.queries": ("siddhi_cluster_queries_total",
                        "scatter-gather on-demand queries served by the "
                        "cluster router"),
}
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
        m = _JUNCTION_GAUGE.match(name)
        if m:
            fams.add(f"siddhi_junction_{m.group('kind')}", "gauge",
                     ("@Async junction queue depth"
                      if m.group("kind") == "queue_depth"
                      else "@Async junction in-flight delivery units"),
                     {**base, "stream": m.group("stream")}, v)
            continue
        m = _QUOTA_GAUGE.match(name)
        if m:
            labels = {**base, "resource": m.group("resource")}
            if m.group("stream"):
                labels["stream"] = m.group("stream")
            fams.add("siddhi_quota_utilization", "gauge",
                     "fraction of the app's overload quota in use (queue "
                     "depth / pipeline entries / device-memory budget)",
                     labels, v)
            continue
        m = _PIPELINE_GAUGE.match(name)
        if m:
            fams.add("siddhi_pipeline_depth", "gauge",
                     "device batches riding the dispatch pipeline",
                     {**base, "query": m.group("query")}, v)
            continue
        m = _JOIN_PART_ROWS.match(name)
        if m:
            fams.add("siddhi_join_partition_rows", "gauge",
                     "live build-side rows per join hash partition (skew "
                     "shows as imbalance)",
                     {**base, "query": m.group("query"), "side": m.group("side"),
                      "partition": m.group("part")}, v)
            continue
        m = _DEVICE_GAUGE.match(name)
        if m:
            labels = {**base, "query": m.group("query"), "slot": m.group("slot")}
            if m.group("cap"):
                fams.add("siddhi_device_instrument_capacity", "gauge",
                         "capacity denominator of a device-instrument slot "
                         "(ring size, Wp, rows_per_shard, ...)", labels, v)
            else:
                fams.add(DEVICE_INSTRUMENT_FAMILY, "gauge",
                         "last drained device-instrument value (rides the "
                         "batch's meta pull: no extra device transfer)",
                         labels, v)
            continue
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
            fams.add(AGGREGATION_SHARDS_FAMILY, "gauge",
                     "in-process key shards of the aggregation "
                     "rollup state",
                     {**base, "name": m.group("agg")}, v)
            continue
        m = _SHARD_ROWS.match(name)
        if m:
            fams.add("siddhi_shard_rows", "gauge",
                     "batch rows routed to each key shard (last batch; skew "
                     "shows as imbalance)",
                     {**base, "query": m.group("scope"),
                      "shard": m.group("shard")}, v)
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
        m = _INGEST_POOL_GAUGE.match(name)
        if m:
            fams.add(f"siddhi_ingest_pool_{m.group('kind')}", "gauge",
                     _INGEST_POOL_HELP[m.group("kind")], base, v)
            continue
        if name == "autopilot.mode":
            fams.add("siddhi_autopilot_mode", "gauge",
                     "closed-loop controller mode per app (0=off, 1=dry_run, "
                     "2=on)", base, v)
            continue
        if name == "cluster.workers.live":
            fams.add("siddhi_cluster_workers_live", "gauge",
                     "worker processes with a live attached link (out of "
                     "cluster_workers)", base, v)
            continue
        m = _CLUSTER_WORKER_GAUGE.match(name)
        if m:
            family, help_ = _CLUSTER_WORKER_GAUGE_HELP[m.group("kind")]
            fams.add(family, "gauge", help_, {**base, "worker": m.group("worker")}, v)
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
        m = _JUNCTION_COUNTER.match(name)
        if m:
            fams.add(f"siddhi_junction_{m.group('kind')}_total", "counter",
                     _JUNCTION_COUNTER_HELP[m.group("kind")],
                     {**base, "stream": m.group("stream")}, v)
            continue
        m = _ELIGIBILITY_COUNTER.match(name)
        if m:
            fams.add("siddhi_eligibility_total", "counter",
                     "build-time strategy-eligibility census: queries "
                     "classified per surface (route / fusion / join_engine / "
                     "join_pipeline) with stable reason codes "
                     "(core/eligibility.py; ELIGIBLE = the strategy applies)",
                     {**base, "surface": m.group("surface"),
                      "code": m.group("code"), "query": m.group("query")}, v)
            continue
        m = _AUTOPILOT_DECISION.match(name)
        if m:
            fams.add("siddhi_autopilot_decisions_total", "counter",
                     "autopilot policy decisions (dry_run and cooldown- or "
                     "damping-blocked ones included; every entry of the GET "
                     "/autopilot decision log counts here once)",
                     {**base, "knob": m.group("knob"),
                      "direction": m.group("direction"),
                      "reason": m.group("reason")}, v)
            continue
        m = _CLUSTER_WORKER_COUNTER.match(name)
        if m:
            family, help_ = _CLUSTER_WORKER_COUNTER_HELP[m.group("kind")]
            fams.add(family, "counter", help_, {**base, "worker": m.group("worker")}, v)
            continue
        fam = (_SERVING_COUNTER_FAMILY.get(name)
               or _INGEST_COUNTER_FAMILY.get(name)
               or _PROGRAM_CACHE_COUNTER_FAMILY.get(name)
               or _PIPELINE_COUNTER_FAMILY.get(name)
               or _CLUSTER_COUNTER_FAMILY.get(name)
               or _AUTOPILOT_COUNTER_FAMILY.get(name))
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
            elif _SHARD_EXCHANGE_HIST.match(name):
                m = _SHARD_EXCHANGE_HIST.match(name)
                family = "siddhi_shard_exchange_ms"
                help_ = ("host time spent routing/prepping one batch for the "
                         "sharded keyed step (ms; the routed path pays only "
                         "pad and pre-check here)")
                labels["query"] = m.group("scope")
            elif name == "scrape.ms":
                family = "siddhi_scrape_ms"
                help_ = "/metrics scrape self-timing (ms)"
            elif _JOIN_HIST.match(name):
                m = _JOIN_HIST.match(name)
                family = f"siddhi_join_{m.group('kind')}_ms"
                help_ = ("host prep time per join side batch (ms)"
                         if m.group("kind") == "insert"
                         else "probe dispatch and finish time per join side "
                              "batch (ms)")
                labels["query"] = m.group("query")
            elif _STAGE_HIST.match(name):
                m = _STAGE_HIST.match(name)
                if m.group("kind") == "service":
                    family = STAGE_MS_FAMILY
                    help_ = ("batch-journey per-stage service time (ms): see "
                             "the stage glossary of observability/journey.py")
                else:
                    family = "siddhi_stage_queue_ms"
                    help_ = "batch-journey per-stage queueing or slack time (ms)"
                labels["query"] = m.group("query")
                labels["stage"] = m.group("stage")
            elif _DEVICE_HIST.match(name):
                m = _DEVICE_HIST.match(name)
                family = "siddhi_device_instrument_value"
                help_ = ("per-batch device-instrument slot value (the slot "
                         "glossary of observability/instruments.py)")
                labels["query"] = m.group("query")
                labels["slot"] = m.group("slot")
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
