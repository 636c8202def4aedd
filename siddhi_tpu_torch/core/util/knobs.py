"""Typed parser registry for every ``siddhi_tpu.*`` config knob.

Counterpart of ``siddhi_tpu/core/util/knobs.py``, with the reference's
whole registry, so a deployment config written for the JAX package parses
unchanged here (keys keep their ``siddhi_tpu.`` names). Every key is
declared once — name, type, accepted spellings, target
``SiddhiAppContext`` attribute — and every read resolves through this
module. A junk value raises ``SiddhiAppValidationException`` naming the
key and the accepted spellings. Knobs of subsystems the port has not
ported yet are accepted and set on the context, where nothing reads them.

Env spellings of process defaults get the same treatment via
:func:`env_knob`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException

PREFIX = "siddhi_tpu."

_TRUE = ("1", "true", "on", "yes")
_FALSE = ("0", "false", "off", "no")

# single source of truth for the overload shed policies — the engine
# (resilience/overload.py OverloadConfig) validates against THIS tuple,
# so a policy added there cannot drift apart from the config parser
SHED_POLICIES = ("block", "shed_oldest", "shed_newest")


@dataclass(frozen=True)
class Knob:
    """One declared config knob (key is the bare name after the
    ``siddhi_tpu.`` prefix)."""

    key: str
    kind: str                       # int | float | bool | enum
    choices: Tuple[str, ...] = ()   # enum spellings
    attr: Optional[str] = None      # SiddhiAppContext attribute to set
    per_stream: bool = False        # accepts a `.{stream}` suffix

    def parse(self, raw):
        s = str(raw).strip()
        if self.kind == "int":
            try:
                return int(s)
            except ValueError:
                raise SiddhiAppValidationException(
                    f"{PREFIX}{self.key} must be an integer, got "
                    f"'{raw}'") from None
        if self.kind == "float":
            try:
                return float(s)
            except ValueError:
                raise SiddhiAppValidationException(
                    f"{PREFIX}{self.key} must be a number, got "
                    f"'{raw}'") from None
        if self.kind == "bool":
            low = s.lower()
            if low in _TRUE:
                return True
            if low in _FALSE:
                return False
            raise SiddhiAppValidationException(
                f"{PREFIX}{self.key} must be a boolean "
                f"({'/'.join(_TRUE + _FALSE)}), got '{raw}'")
        if self.kind == "enum":
            low = s.lower()
            if low in self.choices:
                return low
            raise SiddhiAppValidationException(
                f"{PREFIX}{self.key} must be one of "
                f"{'/'.join(repr(c) for c in self.choices)}, got '{raw}'")
        raise AssertionError(f"unknown knob kind {self.kind!r}")


def _declare(*knobs: Knob) -> Dict[str, Knob]:
    return {k.key: k for k in knobs}


# The registry. `attr` set => apply_app_knobs assigns the parsed value
# onto the SiddhiAppContext; attr None => the subsystem reads it via
# read_knob at its own wiring point.
KNOBS: Dict[str, Knob] = _declare(
    Knob("window_capacity", "int", attr="window_capacity"),
    Knob("partition_window_capacity", "int",
         attr="partition_window_capacity"),
    Knob("nfa_slots", "int", attr="nfa_slots"),
    Knob("initial_key_capacity", "int", attr="initial_key_capacity"),
    Knob("defer_meta", "int", attr="defer_meta"),
    Knob("pipeline_depth", "int", attr="pipeline_depth"),
    Knob("agg_shards", "int", attr="agg_shards"),
    Knob("agg_shard_wal", "int", attr="agg_shard_wal"),
    Knob("join_partitions", "int", attr="join_partitions"),
    Knob("join_partition_slack", "int", attr="join_partition_slack"),
    Knob("index_probe_width", "int", attr="index_probe_width"),
    Knob("ingest_pool", "int", attr="ingest_pool"),
    Knob("ingest_split", "int", attr="ingest_split"),
    Knob("join_partition_grow", "bool", attr="join_partition_grow"),
    Knob("fuse_fanout", "bool", attr="fuse_fanout"),
    Knob("profile_journeys", "bool", attr="profile_journeys"),
    Knob("profile_costs", "bool", attr="profile_costs"),
    Knob("program_cache", "bool", attr="program_cache"),
    Knob("program_cache_max", "int", attr="program_cache_max"),
    Knob("profile_device_instruments", "bool",
         attr="profile_device_instruments"),
    Knob("autopilot", "enum", choices=("off", "on", "dry_run"),
         attr="autopilot"),
    Knob("autopilot_interval_s", "float", attr="autopilot_interval_s"),
    Knob("autopilot_cooldown_s", "float", attr="autopilot_cooldown_s"),
    Knob("route_shards", "int", attr="route_shards"),
    Knob("cluster_step_timeout", "float", attr="cluster_step_timeout"),
    Knob("shard_exchange", "enum", choices=("all_to_all", "pallas_ring"),
         attr="shard_exchange"),
    Knob("join_engine", "enum", choices=("device", "legacy"),
         attr="join_engine"),
    Knob("quota_queue_depth", "int", per_stream=True),
    Knob("shed_policy", "enum", choices=SHED_POLICIES, per_stream=True),
    Knob("quota_pipeline_depth", "int"),
    Knob("quota_memory_mb", "float"),
    Knob("quota_block_timeout_s", "float"),
    Knob("fair_weight", "float"),
    Knob("quota_query_cap", "int"),
    Knob("cluster_workers", "int"),
    Knob("cluster_wal_batches", "int"),
    Knob("cluster_heartbeat_s", "float"),
    Knob("cluster_checkpoint_s", "float"),
)


def read_knob(config_manager, key: str, stream: Optional[str] = None):
    """Read + type one declared knob from a ConfigManager. Returns None
    when unset. The one ``get_property("siddhi_tpu.*")`` call site of the
    package."""
    knob = KNOBS.get(key)
    if knob is None:
        raise KeyError(f"undeclared config knob '{key}' — add it to "
                       f"core/util/knobs.py KNOBS")
    if stream is not None and not knob.per_stream:
        raise KeyError(f"{PREFIX}{key} does not take a per-stream suffix")
    if config_manager is None:
        return None
    full = f"{PREFIX}{key}" + (f".{stream}" if stream is not None else "")
    raw = config_manager.get_property(full)
    if raw is None:
        return None
    try:
        return knob.parse(raw)
    except SiddhiAppValidationException as e:
        if stream is not None:
            # name the FULL per-stream key in the error
            raise SiddhiAppValidationException(
                str(e).replace(f"{PREFIX}{key}", full)) from None
        raise


def apply_app_knobs(config_manager, app_context) -> Dict[str, object]:
    """Apply every context-attribute knob present in the deployment
    config onto ``app_context``; returns ``{key: parsed}`` for the keys
    that were EXPLICITLY set (the defer_meta deprecation shim needs to
    know whether pipeline_depth was the user's own choice)."""
    explicit: Dict[str, object] = {}
    if config_manager is None:
        return explicit
    for key, knob in KNOBS.items():
        if knob.attr is None:
            continue
        val = read_knob(config_manager, key)
        if val is not None:
            setattr(app_context, knob.attr, val)
            explicit[key] = val
    return explicit


def env_knob(name: str, kind: str, default):
    """Typed read of a ``SIDDHI_TPU_*`` process-default env var; junk
    spellings raise naming the variable (same discipline as config
    keys)."""
    raw = os.environ.get(name)
    if raw is None or not str(raw).strip():
        return default
    knob = Knob(name, kind)
    try:
        return knob.parse(raw)
    except SiddhiAppValidationException:
        raise SiddhiAppValidationException(
            f"environment variable {name} must be {kind}, got "
            f"'{raw}'") from None
