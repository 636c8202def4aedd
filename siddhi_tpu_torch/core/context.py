"""Per-manager and per-app contexts threaded through the runtime.

Counterpart of ``siddhi_tpu/core/context.py``. The app context holds the
``torch.device`` every state tensor and step of the app lives on.
"""

from __future__ import annotations

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


class TimestampGenerator:
    """Event/wall clock: live mode returns wall time; playback mode
    returns the last event timestamp."""

    def __init__(self):
        self.playback = False
        self._last_event_ts: int = -1

    def current_time(self) -> int:
        if self.playback and self._last_event_ts >= 0:
            return self._last_event_ts
        return int(time.time() * 1000)

    def set_current_timestamp(self, ts: int):
        if ts > self._last_event_ts:
            self._last_event_ts = ts


class SiddhiAppContext:
    """Per-app context (reference ``core/config/SiddhiAppContext.java``)."""

    def __init__(self, siddhi_context: SiddhiContext, name: str):
        self.siddhi_context = siddhi_context
        self.name = name
        self.device = siddhi_context.device
        self.timestamp_generator = TimestampGenerator()
        self.string_dictionary = StringDictionary()
        self.stopped = False
        # key-capacity default for dense state (padded, grows pow2)
        self.initial_key_capacity = 16
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
        # dispatch pipeline depth: up to N batches per query ride in
        # flight while the host packs the next (core/query/completion.py);
        # 1 = fully synchronous. Set via siddhi_tpu.pipeline_depth;
        # SIDDHI_TPU_PIPELINE_DEPTH overrides the process default, 2 as in
        # the reference (a junk spelling raises naming the variable)
        self.pipeline_depth = env_knob("SIDDHI_TPU_PIPELINE_DEPTH", "int", 2)
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
        # exchange transport of device-routed queries; on one card both
        # values run the ring_exchange kernel (parallel/mesh.py)
        self.shard_exchange = "all_to_all"
        # value slots per group of a distinctCount/unionSet table
        self.distinct_values_capacity = 64
