"""Carry a reference runtime's state into a port runtime.

``load_reference_state`` takes the state of one ``siddhi_tpu`` query as
plain numpy — the canonical unsharded layout that ``jax.device_get`` of an
unrouted runtime's state, or ``canonical_route_state`` of a routed one,
produces — together with the app's string-dictionary id order and the
partition key space, and installs all of it into a port query runtime, so
both packages continue the same feed from the same point. Nothing here
imports the reference: the caller hands over numpy and Python values.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def load_reference_state(runtime, state_tree: Dict, dictionary_ids: Sequence[str],
                         partition_keys: Optional[Dict] = None,
                         group_keys: Optional[Dict] = None) -> None:
    """Install reference state into ``runtime`` (a port ``QueryRuntime``).

    ``state_tree``: ``{"sel": {...}, "win": {...}}`` numpy arrays at the
    reference's capacities. ``dictionary_ids``: the app's strings in id
    order. ``partition_keys``: the partition key space as
    ``PartitionKeySpace.snapshot()`` gives it (``{"map", "free", "n"}``).
    ``group_keys``: the group keyer's ``{"map": {key tuple: id}, "next": n}``
    when the query has a ``group by``. An unpartitioned query's window
    state (the unkeyed length window's ``buf``/``total``, or the fused
    stage's ring, with an empty ``sel``) is installed as it is.

    An unrouted runtime takes the capacities of the tree; a routed one
    (``device_route_query_step`` already installed) lays the canonical
    tree out over its shards."""
    runtime.dictionary.restore_strings(list(dictionary_ids))
    if partition_keys is not None:
        if runtime.partition_ctx is None:
            raise ValueError(f"query '{runtime.name}' is not partitioned")
        runtime.partition_ctx.keyspace.restore(partition_keys)
    if group_keys is not None:
        if runtime.keyer is None:
            raise ValueError(f"query '{runtime.name}' has no group by")
        runtime.keyer._map = dict(group_keys["map"])
        runtime.keyer._next = int(group_keys["next"])
        runtime.keyer._lut = np.full(64, -1, np.int32)   # re-probe raw ids
    sel_keys = _sel_capacity(runtime, state_tree)
    # only a keyed window's state has a per-key axis ([K] totals); the
    # unkeyed length window's total is 0-d and the fused stage has none
    win_keys = 1
    if runtime.partition_ctx is not None and "win" in state_tree:
        win_keys = int(np.asarray(state_tree["win"]["total"]).shape[0])
    layout = runtime._route_layout
    if layout is not None:
        from siddhi_tpu_torch.parallel.mesh import _install_routed

        _install_routed(runtime, layout, state_tree, sel_keys, win_keys)
        return
    runtime.selector_plan.num_keys = sel_keys
    for i, spec in enumerate(runtime.selector_plan.specs):
        st = (state_tree.get("sel") or {}).get(f"a{i}")
        if isinstance(st, dict):       # a value table keeps its width H
            spec.distinct_capacity = int(np.asarray(st["vk"]).shape[1])
    if runtime.partition_ctx is not None:
        runtime._win_keys = win_keys
    runtime._state = _to_tensors(state_tree, runtime.device)
    runtime._step = None


def _sel_capacity(runtime, state_tree) -> int:
    """Key capacity of the selector state: ``[slots, K]`` per aggregator,
    or a distinctCount/unionSet table ``{vk [K, H], vc, stamp, eb}``."""
    sel = state_tree.get("sel") or {}
    if not sel:
        return runtime.selector_plan.num_keys
    st = next(iter(sel.values()))
    if isinstance(st, dict):
        return int(np.asarray(st["vk"]).shape[0])
    return int(np.asarray(st).shape[-1])


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
