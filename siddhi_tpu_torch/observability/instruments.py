"""Device-instrument registry: telemetry slots that ride the meta vector.

Counterpart of ``siddhi_tpu/observability/instruments.py`` (no device
code: the same registry). One declarative spec says what a step's packed
``__meta__`` carries behind the standard ``[overflow, notify, count]``
prefix:

- a step builder declares its instrument slots
  (``QueryRuntime.instrument_slots()`` -> ordered ``[Slot]``);
- the step computes each slot from state and columns it already holds,
  as torch ops inside the step (so on the card inside its CUDA graph:
  no host read, no extra launch of the graph, the lanes come back in the
  one meta pull a batch) and appends the values behind the prefix;
- the CompletionPump drain (and the synchronous tail) decodes the
  suffix by the same spec: ``check`` slots run structural consumers
  (route-overflow raise, join seq verification), data slots feed
  per-query ``device.<query>.<slot>`` telemetry histograms and gauges
  plus a host-side last-drained cache (``_instr_last``) that scrape
  surfaces read with zero device pulls.

Gating: the typed knob ``siddhi_tpu.profile_device_instruments``
(default ON). Off keeps the structural slots only (route overflow and
rows, join seq), in their lanes of the port before the instruments. The
spec enters the query's ``program_signature()`` and so the program
cache's witness: an app with instruments on and one with them off never
share a step. The process-wide collector (the recent-readings ring
below) is refcounted per app runtime like ``profile_journeys``: enabled
at ``start()``, released at ``shutdown()``.

Every declared slot name is one of the ``DEVICE_SLOTS`` /
``DEVICE_CHECK_SLOTS`` declarations in ``observability/export.py``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

import numpy as np

# data slot name -> human-readable structure label, used by
# journey.critical_path_report to NAME the saturated device structure
# ("join right side partition fill p99 = 0.97 of Wp")
SLOT_LABELS: Dict[str, str] = {
    "win_fill": "window ring fill",
    "groups": "distinct groups touched",
    "nfa_runs": "NFA active runs",
    "shard_rows": "shard routed rows",
    "route_residual": "exchange residual capacity",
    "fill.left": "join left side partition fill",
    "fill.right": "join right side partition fill",
}

# data slot name -> the name of its capacity denominator (the knob-ish
# quantity the report quotes the saturation against)
SLOT_CAP_NAMES: Dict[str, str] = {
    "win_fill": "window capacity",
    "groups": "key capacity",
    "nfa_runs": "nfa slots",
    "shard_rows": "rows_per_shard",
    "route_residual": "rows_per_shard",
    "fill.left": "Wp",
    "fill.right": "Wp",
}

# slots where saturation means the value approaches ZERO (a residual),
# not the capacity — the report's ratio inverts for these
RESIDUAL_SLOTS = ("route_residual",)

_DEFAULT_RING = 2048


class Slot:
    """One declared instrument slot of a step's meta suffix.

    ``width`` is the number of int64 meta lanes it occupies (1 for
    scalars; n for per-shard vectors, P for per-partition fills).
    ``kind``: ``"check"`` slots are structural — consumed by the
    runtime's ``_consume_check_slot`` hook (route-overflow raise, join
    seq verification) and present regardless of the knob; data slots
    (``"gauge"``) feed ``device.<query>.<slot>`` telemetry. ``reduce``
    tells the device-routed wrapper how to aggregate an inner step's
    per-shard lane across the mesh (``sum`` for counts owned by one
    shard each, ``max`` for fill levels)."""

    __slots__ = ("name", "width", "kind", "reduce")

    def __init__(self, name: str, width: int = 1, kind: str = "gauge",
                 reduce: str = "sum"):
        self.name = name
        self.width = int(width)
        self.kind = kind
        self.reduce = reduce

    def __repr__(self):  # pragma: no cover — debugging aid
        return (f"Slot({self.name!r}, width={self.width}, "
                f"kind={self.kind!r})")


# ------------------------------------------------------- process collector

_ENABLED = False
_enable_count = 0
_lock = threading.RLock()
# recent drained readings: (app, query, slot, value, capacity) dicts —
# bounded, reset on first enable (tests/tools introspection surface)
_RING: deque = deque(maxlen=_DEFAULT_RING)


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    """Refcounted process-wide enable (one ``disable()`` per
    ``enable()``; app runtimes whose ``profile_device_instruments``
    knob is on hold one ref for their lifetime, like
    ``profile_journeys``)."""
    global _ENABLED, _enable_count
    with _lock:
        _enable_count += 1
        if not _ENABLED:
            _RING.clear()
            _ENABLED = True


def disable(force: bool = False) -> None:
    global _ENABLED, _enable_count
    with _lock:
        _enable_count = 0 if force else max(0, _enable_count - 1)
        if _enable_count == 0:
            _ENABLED = False


def ring() -> list:
    """Snapshot of recent drained instrument readings (newest last)."""
    with _lock:
        return list(_RING)


def app_instruments_on(app_context) -> bool:
    """Is the instrument suffix enabled for this app? Read at STEP BUILD
    time and at drain time — both sides see the same per-app knob, so
    the compiled layout and the decoder cannot disagree."""
    return bool(getattr(app_context, "profile_device_instruments", True))


# -------------------------------------------------------------- recording

def summary_value(vals: np.ndarray) -> float:
    """The scalar a multi-lane slot reports into its histogram/gauge:
    the MAX lane (skew/saturation is what the signal is for)."""
    return float(vals.max()) if vals.size > 1 else float(vals[0])


def record(runtime, slot: Slot, vals: np.ndarray,
           capacity: Optional[float] = None) -> None:
    """Drain-side sink of one data slot: feed the per-query
    ``device.<query>.<slot>`` histogram, lazily register the last-value
    (and capacity) gauges, and remember the raw lanes on the runtime
    (``_instr_last``) for zero-pull scrape surfaces like
    ``partition_occupancy``. Called once per drained batch per slot —
    a handful of dict writes and one O(1) histogram record."""
    tel = getattr(runtime.app_context, "telemetry", None)
    if tel is None:
        return
    q = runtime.name
    val = summary_value(vals)
    tel.histogram(f"device.{q}.{slot.name}").record(val)
    if capacity is not None:
        runtime._instr_caps[slot.name] = float(capacity)
    if slot.name not in runtime._instr_gauged:
        runtime._instr_gauged.add(slot.name)
        tel.gauge(f"device.{q}.{slot.name}",
                  lambda r=runtime, s=slot.name: _last_value(r, s))
        if capacity is not None:
            tel.gauge(f"device.{q}.{slot.name}.capacity",
                      lambda r=runtime, s=slot.name:
                      float(r._instr_caps.get(s, 0.0)))
    if _ENABLED:
        with _lock:
            _RING.append({
                "app": getattr(runtime.app_context, "name", ""),
                "query": q, "slot": slot.name,
                "value": val, "capacity": capacity,
            })


def _last_value(runtime, slot_name: str) -> float:
    vals = runtime._instr_last.get(slot_name)
    if vals is None:
        return 0.0
    return summary_value(np.asarray(vals))
