"""Per-manager and per-app contexts threaded through the runtime.

Counterpart of ``siddhi_tpu/core/context.py``. The app context holds the
``torch.device`` every state tensor and step of the app lives on.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from siddhi_tpu_torch.core.event import StringDictionary


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
        # dispatch pipeline depth: parsed so configs carry over; the port
        # dispatches synchronously (depth 1)
        self.pipeline_depth = 1
        # exchange transport of device-routed queries; on one card both
        # values run the ring_exchange kernel (parallel/mesh.py)
        self.shard_exchange = "all_to_all"
        # value slots per group of a distinctCount/unionSet table
        self.distinct_values_capacity = 64
