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

from siddhi_tpu_torch.core.util.snapshot import SnapshotService, install_table_state


def load_reference_state(runtime, state_tree: Dict, dictionary_ids: Sequence[str],
                         partition_keys: Optional[Dict] = None,
                         group_keys: Optional[Dict] = None,
                         nfa_hwm: Optional[np.ndarray] = None) -> None:
    """Install reference state into ``runtime`` (a port ``QueryRuntime``).

    ``state_tree``: ``{"sel": {...}, "win": {...}}`` numpy arrays at the
    reference's capacities; a pattern query's is ``{"sel": {...}, "nfa":
    {...}}`` (its ``[K, S]`` slot tensors), with the per-key event-time
    high-water marks the reference keeps for its fast-path dispatch as
    ``nfa_hwm`` (``NFAQueryRuntime._nfa_hwm_arr``). ``dictionary_ids``:
    the app's strings in id order. ``partition_keys``: the partition key space as
    ``PartitionKeySpace.snapshot()`` gives it (``{"map", "free", "n"}``).
    ``group_keys``: the group keyer's ``{"map": {key tuple: id}, "next": n}``
    when the query has a ``group by``. An unpartitioned query's window
    state (the unkeyed length window's ``buf``/``total``, or the fused
    stage's ring, with an empty ``sel``) is installed as it is.

    A join runtime's tree is ``{"sel", "lwin", "rwin"}`` (a windowless
    side's ``{"empty"}`` included) without the engine's partition
    directories and sequence, which the reference strips from its
    snapshots too (``ENGINE_STATE_KEYS``): they are rebuilt from the rings
    here. A table (``runtime`` an ``InMemoryTable``) takes ``{"cols",
    "valid"}`` at the reference's capacity.

    An unrouted runtime takes the capacities of the tree; a routed one
    (``device_route_query_step`` already installed) lays the canonical
    tree out over its shards. The install is a snapshot restore's
    (``SnapshotService._restore_query``, ``install_table_state``): a leaf
    whose dtype differs from the runtime's own raises, naming it."""
    runtime.dictionary.restore_strings(list(dictionary_ids))
    if "valid" in state_tree and hasattr(runtime, "probe_attrs"):
        install_table_state(runtime, state_tree,
                            int(np.asarray(state_tree["valid"]).shape[0]))
        return
    if partition_keys is not None:
        if runtime.partition_ctx is None:
            raise ValueError(f"query '{runtime.name}' is not partitioned")
        runtime.partition_ctx.keyspace.restore(partition_keys)
    if group_keys is not None and runtime.keyer is None:
        raise ValueError(f"query '{runtime.name}' has no group by")
    # only a keyed window's state has a per-key axis ([K] totals); the
    # unkeyed length window's total is 0-d and the fused stage has none
    win_keys = runtime._win_keys
    if runtime.partition_ctx is not None:
        for key in ("win", "lwin", "rwin"):
            if key in state_tree:
                win_keys = int(np.asarray(state_tree[key]["total"]).shape[0])
    if "nfa" in state_tree:
        win_keys, slots = np.asarray(state_tree["nfa"]["active"]).shape
        if slots != runtime.stage.plan.slots:
            raise ValueError(
                f"query '{runtime.name}': the reference state holds {slots} "
                f"match slots a key, the port runtime "
                f"{runtime.stage.plan.slots} (siddhi_tpu.nfa_slots)")
    # one installer for carried state and for snapshots: the per-query
    # part of a revision, with its dtype checks
    qsnap = {"state": state_tree,
             "sel_keys": _sel_capacity(runtime, state_tree),
             "win_keys": int(win_keys),
             "keyer_map": None if group_keys is None else group_keys["map"],
             "host_window": None,
             "nfa_hwm": nfa_hwm}
    SnapshotService(None)._restore_query(runtime, qsnap, runtime.device)
    if group_keys is not None:
        runtime.keyer._next = int(group_keys["next"])


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
