"""Inventory of every step construction of the port and its instrument family.

Counterpart of ``siddhi_tpu/analysis/step_registry.py`` (a copy of its
data with the port's own call sites; nothing is imported from the JAX
package). Every code path that makes a step hands it to the step instrument
(``observability.telemetry.InstrumentedJit`` through ``instrument_jit``)
under a ``family`` tag. The tag is part of the program cache's witness
(``core/util/program_cache.py``): two constructions that run equal ops under
different wrappers must never share.
``tests/test_torch_program_cache.py`` checks that each declared tag still
appears at an ``instrument_jit`` call site in its named module.

Entries are (dotted module path, attribute), importable without torch's
card and checked by a plain resolve.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

# audit name -> (module, attr) of the code that makes the step
JIT_STEP_BUILDERS: Dict[str, Tuple[str, str]] = {
    # per-query single-stream step (QueryRuntime._make_step)
    "query_step": ("siddhi_tpu_torch.core.query.runtime", "QueryRuntime"),
    # fused sibling queries: one step per junction group
    "fused_fanout": ("siddhi_tpu_torch.core.query.fused_fanout",
                     "FusedFanoutRuntime"),
    # device-side repartitioning: the routed step over n shards (one
    # card, or across processes)
    "device_routed": ("siddhi_tpu_torch.parallel.mesh",
                      "device_route_query_step"),
    # the key-sharded step with a replicated batch across processes
    "sharded_step": ("siddhi_tpu_torch.parallel.mesh", "shard_query_step"),
    # the deprecated host-routed shim: each shard's step over its slice
    "shard_map_routed": ("siddhi_tpu_torch.parallel.mesh",
                         "shard_keyed_query_step"),
    # the join engine's side step (insert and probe)
    "device_join": ("siddhi_tpu_torch.core.join.engine", "DeviceJoinEngine"),
    # serving tier: the sharded aggregation's on-demand selectors
    "sharded_agg": ("siddhi_tpu_torch.serving.sharded_aggregation",
                    "ShardedIncrementalAggregation"),
}

# audit name -> the family tag(s) its code passes to instrument_jit.
# ``sharded_agg`` is absent, as in the reference: its selectors fold on
# the host.
PROGRAM_CACHE_FAMILIES: Dict[str, Tuple[str, ...]] = {
    "query_step": ("query_step", "selector"),
    "fused_fanout": ("fused_fanout",),
    # a routed join's side steps tag device_routed.left/right
    "device_routed": ("device_routed",),
    "sharded_step": ("gspmd_replicated_batch",),
    "shard_map_routed": ("shard_map_routed",),
    # NFA steps ride QueryRuntime's module family (pattern/sequence queries)
    "nfa_step": ("nfa_step", "nfa_timer"),
    # join sides tag per side at the call site: device_join.left/right
    "device_join": ("device_join",),
}

# family tags above that are PREFIXES of the call-site tag (the call site
# appends a dynamic suffix, e.g. ``device_join.left``)
PROGRAM_CACHE_PREFIX_FAMILIES = ("device_join", "device_routed")

# module of each family's instrument_jit call site in the port. The join
# engine's side steps (core/join/engine.py) go through the join runtime's
# step cache, so both join probes instrument at one site.
PROGRAM_CACHE_FAMILY_SITES: Dict[str, str] = {
    "query_step": "siddhi_tpu_torch.core.query.runtime",
    "selector": "siddhi_tpu_torch.core.query.runtime",
    "fused_fanout": "siddhi_tpu_torch.core.query.fused_fanout",
    "device_routed": "siddhi_tpu_torch.parallel.mesh",
    "gspmd_replicated_batch": "siddhi_tpu_torch.parallel.mesh",
    "shard_map_routed": "siddhi_tpu_torch.parallel.mesh",
    "nfa_step": "siddhi_tpu_torch.core.query.nfa_runtime",
    "nfa_timer": "siddhi_tpu_torch.core.query.nfa_runtime",
    "device_join": "siddhi_tpu_torch.core.query.join_runtime",
}

# families that are instrumented (compile events, costs) but hold no
# program-cache entry in the port, and why: their steps read the host,
# so no one device program exists to share (a departure: the reference
# shares every jitted step)
PORT_EAGER_FAMILIES: Dict[str, str] = {
    "selector": ("the split path's selector runs after the host keys a "
                 "stage's output (QueryRuntime._host_keyed_select)"),
    "nfa_step": ("the host picks K4 or K5 for each batch and lays K5's "
                 "rounds out (NFAQueryRuntime._host_hard_batch)"),
    "nfa_timer": "the timer step rides the NFA runtime's host dispatch",
    "gspmd_replicated_batch": ("across processes the step's egress sizes "
                               "every process's emitted rows on the host "
                               "(ops/exchange.all_gather_rows); on one "
                               "process no sharded step exists"),
    "shard_map_routed": ("the deprecated host-routed shim steps each "
                         "shard in turn over host-routed columns "
                         "(route_batch_to_shards); it is never captured"),
    "device_join": ("a side step reads its match count back "
                    "(join_runtime.materialize_joined; the engine's "
                    "occupancy mirror in DeviceJoinEngine.prepare_batch)"),
}


def resolve(name: str):
    """Import and return the registered constructor (a renamed or moved
    one fails loudly)."""
    module, attr = JIT_STEP_BUILDERS[name]
    return getattr(importlib.import_module(module), attr)
