"""Per-manager and per-app contexts threaded through the runtime.

Counterpart of ``siddhi_tpu/core/context.py``. The app context holds the
``torch.device`` every state tensor and step of the app lives on, the
app's always-on telemetry registry (``observability/telemetry.py``), its
``StatisticsManager`` under ``@app:statistics`` and its ingest WAL once
``SiddhiAppRuntime.enable_wal`` attaches one.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

import torch

from siddhi_tpu_torch.core.event import StringDictionary
from siddhi_tpu_torch.core.query.completion import CompletionPump
from siddhi_tpu_torch.core.util.knobs import env_knob


class SiddhiContext:
    """Per-SiddhiManager shared services (reference ``SiddhiContext.java``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.config_manager = None
        # custom extensions by name (SiddhiManager.set_extension), e.g.
        # 'function:custom:plus' -> a ScalarFunction class
        self.extensions: Dict[str, type] = {}
        # where persist() writes revisions (core/util/persistence.py);
        # SiddhiManager.set_persistence_store
        self.persistence_store = None


class TimestampGenerator:  # graftlint: disable=R8 — listener list is
    # mutated at single-threaded wiring time only; the heartbeat thread
    # iterates a snapshot (tuple) of it, and one-shot listeners remove
    # themselves inside that same iteration
    """Event/wall clock: live mode returns wall time; playback mode
    returns the last event timestamp. Time-change listeners (the playback
    scheduler) run inside ``set_current_timestamp``. The
    ``@app:playback(idle.time, increment)`` heartbeat advances the event
    clock by ``increment`` when no event arrives for ``idle.time`` of wall
    time, so time windows keep draining."""

    def __init__(self):
        self.playback = False
        self._last_event_ts: int = -1
        self._increment_listeners = []
        self._hb_idle_ms: int = 0
        self._hb_increment_ms: int = 0
        self._hb_thread = None
        self._hb_stop = None
        self._hb_barrier = None

    def current_time(self) -> int:
        if self.playback and self._last_event_ts >= 0:
            return self._last_event_ts
        return int(time.time() * 1000)

    def set_current_timestamp(self, ts: int):
        if ts > self._last_event_ts:
            self._last_event_ts = ts
            # a snapshot: one-shot listeners remove themselves mid-iteration
            for listener in tuple(self._increment_listeners):
                listener(ts)
        if self._hb_idle_ms and self._hb_thread is None:
            self._start_heartbeat()

    def reset_timestamp(self, ts: int):
        """Force the event clock (restore, rollback): unlike
        ``set_current_timestamp`` it may move backward, and it fires no
        time-change listeners (restored timers re-arm separately)."""
        self._last_event_ts = int(ts)

    def configure_heartbeat(self, idle_ms: int, increment_ms: int):
        self._hb_idle_ms = int(idle_ms)
        self._hb_increment_ms = int(increment_ms)

    def set_heartbeat_barrier(self, lock):
        """The app's ingestion barrier: heartbeat ticks advance the clock
        under it, so they serialize with ``InputHandler.send``."""
        self._hb_barrier = lock

    def _start_heartbeat(self):
        self._hb_stop = threading.Event()
        stop = self._hb_stop
        barrier = self._hb_barrier or threading.RLock()

        def _run():
            seen = self._last_event_ts
            while not stop.wait(self._hb_idle_ms / 1000.0):
                with barrier:
                    cur = self._last_event_ts
                    if cur == seen and cur >= 0 and not stop.is_set():
                        # idle: advance the event clock (fires timers)
                        self.set_current_timestamp(cur + self._hb_increment_ms)
                    seen = self._last_event_ts

        self._hb_thread = threading.Thread(
            target=_run, name="playback-heartbeat", daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self):
        # idle_ms goes to 0 first, so the lazy start in
        # set_current_timestamp never brings a thread back after shutdown
        self._hb_idle_ms = 0
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_thread = None
            self._hb_stop = None

    def add_time_change_listener(self, fn):
        self._increment_listeners.append(fn)

    def remove_time_change_listener(self, fn):
        try:
            self._increment_listeners.remove(fn)
        except ValueError:
            pass

    def once_first_time(self, fn):
        """Run ``fn(first_ts)`` when the event clock first advances (the
        playback anchor of periodic jobs); returns a cancel() callable."""
        def _listener(ts: int):
            self.remove_time_change_listener(_listener)
            fn(ts)

        self.add_time_change_listener(_listener)

        def cancel():
            self.remove_time_change_listener(_listener)

        return cancel


class SiddhiAppContext:
    """Per-app context (reference ``core/config/SiddhiAppContext.java``)."""

    def __init__(self, siddhi_context: SiddhiContext, name: str):
        self.siddhi_context = siddhi_context
        self.name = name
        self.device = siddhi_context.device
        self.timestamp_generator = TimestampGenerator()
        self.playback = False
        # the app's Scheduler (core/util/scheduler.py), set by the app
        # runtime: TIMER chunks of time windows and time rate limiters
        self.scheduler = None
        self.string_dictionary = StringDictionary()
        self.stopped = False
        # @app:statistics (core/util/statistics.py); None = not collected
        self.statistics_manager = None
        # always-on telemetry registry (observability/telemetry.py):
        # gauges, counters and histograms scraped by GET /metrics, apart
        # from statistics_manager, which exists under @app:statistics only
        from siddhi_tpu_torch.observability.telemetry import TelemetryRegistry

        self.telemetry = TelemetryRegistry()
        # bound to this context: the step instrument reads the program
        # cache's knobs through it, and the registry INSTANCE is the app's
        # identity-pinned owner token in the process-global program cache
        # (core/util/program_cache.py): unique per runtime, so a blue/green
        # replace's old runtime can never release the new runtime's refs
        self.telemetry.app_context = self
        self.telemetry.owner_name = name
        # @app:enforceOrder: a send behind a stream's watermark raises
        # (core/stream/input/input_handler.py)
        self.enforce_order = False
        # the bounded ingest replay log (resilience/replay.py), attached
        # by SiddhiAppRuntime.enable_wal
        self.ingest_wal = None
        # key-capacity default for dense state (padded, grows pow2)
        self.initial_key_capacity = 16
        # ring capacity of the unbounded (time and batch) windows; a ring
        # that would hold more live rows raises FatalQueryError naming
        # siddhi_tpu.window_capacity
        self.window_capacity = 4096
        # siddhi_tpu.partition_window_capacity: a keyed window's rows per key
        self.partition_window_capacity = 256
        # numeric precision of the fused sliding aggregation
        # (ops/fused_agg.py, its one reader): 'exact' = 64-bit accumulators
        # (the reference's double math), 'fast' = float32. The reference
        # defaults to 'fast' on a TPU, which emulates 64-bit floats in
        # software; the H100 runs FP64 natively, so the port defaults to
        # 'exact' on every device. Overridable with @app:precision.
        self.precision = "exact"
        # the planner may fuse a global length window into its invertible
        # aggregators (reference core/context.py enable_fusion)
        self.enable_fusion = True
        # sibling queries on one junction run as one fused step, one meta
        # pull a batch (core/query/fused_fanout.py); config key
        # siddhi_tpu.fuse_fanout
        self.fuse_fanout = True
        # dispatch pipeline depth: up to N batches per query ride in
        # flight while the host packs the next (core/query/completion.py);
        # 1 = fully synchronous. Set via siddhi_tpu.pipeline_depth;
        # SIDDHI_TPU_PIPELINE_DEPTH overrides the process default, 2 as in
        # the reference (a junk spelling raises naming the variable)
        self.pipeline_depth = env_knob("SIDDHI_TPU_PIPELINE_DEPTH", "int", 2)
        # first-call cost capture of every step program
        # (observability/costmodel.py): enables the process-wide registry
        # for this runtime's life. Key siddhi_tpu.profile_costs;
        # SIDDHI_TPU_PROFILE_COSTS=1 and POST /profile/costs/start turn it
        # on process-wide without a config. Default off
        self.profile_costs = False
        # batch-journey stage tracing (observability/journey.py): holds
        # one ref on the process-wide journey collector for this
        # runtime's life (refcounted across apps). Key
        # siddhi_tpu.profile_journeys; POST /profile/journeys/start turns
        # it on process-wide without a config. Default off
        self.profile_journeys = False
        # device instruments (observability/instruments.py): each step
        # appends its declared slots (window ring fill, join partition
        # fill, NFA active runs, routed-row skew, groups touched) behind
        # the [overflow, notify, count] meta prefix, computed inside the
        # step (on the card inside its CUDA graph) and pulled with the
        # meta. Default on; 'false' keeps the meta layouts of the port
        # before the instruments. Key siddhi_tpu.profile_device_instruments
        self.profile_device_instruments = True
        # the process-global program cache (core/util/program_cache.py):
        # equal capturable step programs are built (and on the card
        # captured) once and shared across apps, each app's state its own.
        # Default on; 'false' gives every app its own steps and graphs.
        # program_cache_max caps live entries. Keys
        # siddhi_tpu.program_cache / siddhi_tpu.program_cache_max;
        # SIDDHI_TPU_PROGRAM_CACHE / _MAX set the process defaults
        self.program_cache = env_knob("SIDDHI_TPU_PROGRAM_CACHE", "bool", True)
        self.program_cache_max = env_knob("SIDDHI_TPU_PROGRAM_CACHE_MAX", "int", 256)
        # deprecated: values > 1 are mapped onto pipeline_depth at app
        # build (app_runtime.py), as the reference does
        self.defer_meta = 1
        self.completion_pump = CompletionPump(self)
        # multicore ingest (core/stream/input/pack_pool.py): > 0 packs
        # large batches on that many threads, in sub-batches of
        # ingest_split rows; the pool starts with the app
        self.ingest_pool = 0
        self.ingest_split = 8192
        self.ingest_pack_pool = None
        # the app supervisor (resilience/supervisor.py), attached by
        # SiddhiAppRuntime.supervise
        self.supervisor = None
        # overload control (resilience/overload.py): per-app queue quotas
        # with shed policies, the pipeline quota, the device-memory budget
        # and the fair-share weight. None = no quotas; set by
        # OverloadManager.register through the siddhi_tpu.quota_* and
        # siddhi_tpu.shed_policy keys or rt.enable_overload()
        self.overload = None
        # the closed-loop controller (autopilot/): 'off' (the default)
        # registers nothing; 'dry_run' observes, decides and logs, never
        # actuates; 'on' actuates the live knobs within their bounds. Keys
        # siddhi_tpu.autopilot / .autopilot_interval_s /
        # .autopilot_cooldown_s; rt.enable_autopilot() sets them
        self.autopilot = "off"
        self.autopilot_interval_s = 0.25
        self.autopilot_cooldown_s = 5.0
        # the route_shards actuator's ceiling of logical shards (0 = the
        # actuator's default, autopilot/actuators.py)
        self.route_shards = 0
        # exchange transport of device-routed queries; on one card both
        # values run the ring_exchange kernel (parallel/mesh.py)
        self.shard_exchange = "all_to_all"
        # siddhi_tpu.agg_shards > 1 key-partitions every incremental
        # aggregation's bucket stores across that many in-process shards
        # (serving/sharded_aggregation.py); @PartitionById aggregations
        # keep the single-store runtime. siddhi_tpu.agg_shard_wal bounds
        # each shard's WAL in batches (0 = no shard WALs)
        self.agg_shards = 1
        self.agg_shard_wal = 1024
        # value slots per group of a distinctCount/unionSet table
        self.distinct_values_capacity = 64
        # match slots per key of a pattern/sequence query (ops/nfa.py);
        # set via siddhi_tpu.nfa_slots, overflow raises FatalQueryError
        self.nfa_slots = 32
        # joins (core/join/): 'device' attaches the partitioned engine to
        # eligible stream-stream joins, 'legacy' keeps the broadcast probe;
        # join_partitions 0 = auto (8 on the card, 1 on the CPU), the
        # sub-window slack over W / P, adaptive sub-window growth, and the
        # candidate window of an indexed table probe
        self.join_engine = "device"
        self.join_partitions = 0
        self.join_partition_slack = 2
        self.join_partition_grow = True
        self.index_probe_width = 64
        # the app's tables and named windows by id (set by the app
        # runtime; the planner resolves join sides and `in` probes here)
        self.tables: Dict = {}
        self.named_windows: Dict = {}
        self.aggregations: Dict = {}
