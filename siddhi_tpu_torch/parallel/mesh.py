"""Key sharding of query state over n shards, on one card or across processes.

Counterpart of ``siddhi_tpu/parallel/mesh.py``. A ``Mesh`` is n logical
shards spread over ``process_count`` processes (``parallel/distributed.py``),
``n / process_count`` of them on each process's one device; process p owns
global shards ``[p*L, (p+1)*L)``. ``make_mesh(n)`` is one process with n
shards. Two ways to shard a query:

``device_route_query_step``  the routed step. State is laid out in the
reference's shard-major layout (``_canonical_to_routed``): shard s owns
key rows ``[s*localK, (s+1)*localK)`` of every keyed state tensor, and a
process holds only its own shards' rows. One routed step:

ingress   every process sees the whole (replicated) batch; it cuts its
          own source slices out of ``[n, B/n]``, ``owner = key % n`` per
          row, and buckets rows per (source, owner) with a per-pair quota
          of ``rows_per_shard // n`` (over-quota rows are counted, not
          silently dropped). One ``ring_exchange_cols`` call (one kernel
          launch) moves every column's buckets between the process's own
          shards; under ``all_to_all`` the buckets bound for another
          process travel in one ``all_to_all_single``
          (``ops/exchange.process_exchange_plain``), under ``pallas_ring``
          one launch of K8 writes every bucket straight into its owner
          process's receive buffer (``ops/exchange.peer_exchange_cols``).
          Rows arrive source-major, i.e. in original batch order.
local     partition- and group-key columns become per-shard local ids
          (pk // n; the group key through a host-kept LUT) and each shard
          steps views of its own state slice, in place.
egress    emitted rows of all shards (of all processes: one
          ``all_gather``) are concatenated and sorted once by their global
          emission-order key, which reproduces the unrouted output row for
          row. The meta is
          ``[overflow, notify, count, route_overflow, rows_0..rows_n-1]``.

``shard_query_step``  the key-sharded step with a replicated batch. On a
one-process mesh the state stays whole: n logical shards of one card
share one memory. Across processes each process keeps its own key rows
(one shard a process, round robin: global key g lives on process g % P as
local id g // P) and steps the whole batch over its own keys; the emitted
rows are gathered and merged once in the unsharded order.

On one card both values of ``siddhi_tpu.shard_exchange`` (``all_to_all``,
``pallas_ring``) take the one ``ring_exchange_cols`` call per dispatch.
Across processes ``all_to_all`` moves the remote buckets with the group's
collective; ``pallas_ring`` runs K8 as peer writes through CUDA IPC (one
launch a dispatch in each process, into arenas every process maps: the
processes share one host, and their cards are one card or reach each
other by peer access). Unlike the reference, nothing swaps the exchange
for another off the accelerator: a CPU runtime uses the kernel's plain
version because its tensors lie on the CPU.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from siddhi_tpu_torch.observability.tracing import span
from siddhi_tpu_torch.ops.exchange import (
    PeerExchange, peer_exchange_cols, process_exchange_plain, ring_exchange_cols)
from siddhi_tpu_torch.ops.expressions import (
    OKEY_KEY, PK_KEY, RIDX_KEY, TYPE_KEY, VALID_KEY, CompileError)

# the name of a mesh's one axis: keyed state shards over it
KEY_AXIS = "keys"
GK_KEY = "__gk__"
# the group-key LUT pair of a routed step with a distinct group key
# (``RouteLayout.device_luts``), staged before the step as input columns:
# a captured step reads its static copies, and the LUT is each app's own
LUT_KEY = "__route_lut__"
INV_KEY = "__route_inv__"
# a partitioned host window's wake time on this process, staged as an
# input column of the key-sharded step across processes (merged like the
# step's own)
HOST_NOTIFY_KEY = "__host_notify__"
_ROUTE_BIG = 2 ** 62


@dataclass(frozen=True)
class Mesh:
    """n shards over ``process_count`` processes, ``n / process_count`` on
    each process's device (``None``: the runtime's device). Process p owns
    global shards ``[p * local, (p + 1) * local)``."""

    n: int
    device: Optional[torch.device] = None
    process_count: int = 1
    process_index: int = 0

    def __post_init__(self):
        if self.n < 1 or self.process_count < 1 or self.n % self.process_count:
            raise ValueError(
                f"Mesh: {self.n} shards do not split over "
                f"{self.process_count} processes")
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"Mesh: process index {self.process_index} of "
                             f"{self.process_count}")

    @property
    def local(self) -> int:
        """Shards on this process."""
        return self.n // self.process_count

    @property
    def first(self) -> int:
        """This process's first global shard."""
        return self.process_index * self.local


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` logical shards co-resident on ``device``
    (one process; default one shard, the process's one device, as the
    reference's default is every device)."""
    if n_devices is None:
        n_devices = 1
    if int(n_devices) < 1:
        raise ValueError(f"make_mesh: need at least one shard, got {n_devices}")
    return Mesh(int(n_devices), torch.device(device) if device is not None else None)


# ------------------------------------------------------------ state trees

def _map_tree(fn, tree, *others, path=()):
    """Map ``fn(path, leaf, *other_leaves)`` over nested dicts of tensors."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(o[k] for o in others), path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *others)


def _key_axis_of(path, leaf, num_keys: int, win_keys: int) -> int:
    """Key-axis index of a query-state leaf, or -1 if unkeyed: selector
    arrays (``"sel"``, shape ``[slots, K]``, and the distinct value tables
    ``[K, H]`` and their ``[K]`` stamps) by the axis sized ``num_keys``;
    partitioned window buffers (``"win"``, and a partitioned join's
    per-side rings ``"lwin"``/``"rwin"``: key-contiguous flat rings
    ``[Kw*W]`` or per-key ``[Kw]``) along axis 0; NFA slot tensors
    (``"nfa"``: key-major ``[K, S]`` / per-key ``[K]``) along axis 0."""
    if leaf.dim() == 0:
        return -1
    top = path[0] if path else None
    if top == "sel":
        for i, s in enumerate(leaf.shape):
            if s == num_keys:
                return i
    if (top in ("win", "lwin", "rwin") and win_keys > 1
            and leaf.shape[0] % win_keys == 0):
        return 0
    if top == "nfa" and win_keys > 1 and leaf.shape[0] == win_keys:
        return 0
    return -1


def key_axis_sharding(mesh: Mesh, arr_ndim: int, key_axis_index: int) -> int:
    """The layout of one array sharded along its key axis over ``mesh``,
    the rest replicated: the key axis itself (the form ``state_shardings``
    gives each keyed leaf; the reference returns a ``NamedSharding``)."""
    if not 0 <= key_axis_index < arr_ndim:
        raise ValueError(f"key axis {key_axis_index} of a {arr_ndim}-d array")
    return int(key_axis_index)


def batch_shardings(cols, mesh: Mesh):
    """The layout of a batch's columns over ``mesh``: every column
    replicated (-1, as ``state_shardings`` marks unkeyed state). The
    reference splits each ``[B, ...]`` column along the batch axis for
    GSPMD; the port's steps take the whole batch on every process, and a
    routed step cuts its own source slices (``device_route_query_step``)."""
    return {k: -1 for k in cols}


def state_shardings(state, mesh: Mesh, num_keys: int, win_keys: int = 1):
    """The tree of key axes of a query-state tree over ``mesh``: each
    leaf's axis to shard along, or -1 where it stays replicated (unkeyed
    state, and window or NFA buffers whose key count does not split over
    the mesh's processes). The port's counterpart of the reference's
    ``NamedSharding`` tree: ``shard_query_step`` splits the keyed leaves
    one shard a process."""
    parts = mesh.process_count

    def one(path, leaf):
        ax = _key_axis_of(path, leaf, num_keys, win_keys)
        if ax < 0:
            return -1
        if path[0] in ("win", "lwin", "rwin", "nfa") and (
                leaf.shape[0] % parts or win_keys % parts):
            return -1
        return ax

    return _map_tree(one, state)


def _leaf_space(path) -> str:
    return "gk" if path and path[0] == "sel" else "pk"


def _buffered_id_col(path) -> Optional[str]:
    """'gk'/'pk' when this window-buffer leaf stores key ids whose VALUES
    must translate between local and global id spaces."""
    if path and path[0] in ("win", "lwin", "rwin") and path[-1] in (GK_KEY, PK_KEY):
        return "gk" if path[-1] == GK_KEY else "pk"
    return None


class RouteLayout:
    """Host-side bookkeeping of one routed query: shard count (``n`` in
    all, ``L`` on this process from global shard ``first``, over ``P``
    processes), receive capacity, and the group-key local-id LUT that
    carries a distinct GK through the exchange. ``localK``/``local_win``
    mirror the runtime's per-shard capacity fields; ``n * localK`` is the
    global dense-id capacity the keyer allocates into."""

    def __init__(self, mesh: Mesh, rows_per_shard: int, exchange: str,
                 partitioned: bool, use_lut: bool, device, split: Optional[str] = None,
                 sel_whole: bool = False):
        self.mesh = mesh
        # ``split`` set: the key-sharded step with a replicated batch
        # (shard_query_step across processes), one shard a process, which
        # takes its rows at the step's input ("input") or, behind a global
        # window, at the selector's ("select")
        self.split = split
        # the selector's state whole on every process (a pattern's group by
        # over captures: the host keys the merged matches, then selects)
        self.sel_whole = sel_whole
        self.P = mesh.process_count
        self.n = mesh.process_count if split else mesh.n
        self.L = 1 if split else mesh.local      # shards on this process
        self.first = mesh.process_index * self.L  # its first global shard
        self.device = device
        self.rows_per_shard = int(rows_per_shard)
        self.quota = max(1, self.rows_per_shard // self.n)
        self.exchange = exchange
        self.partitioned = partitioned
        self.use_lut = use_lut
        self.localK = 1
        self.local_win = 1
        # group-key space: global gk id -> (owner shard, per-shard local id)
        self.gk_owner = np.full(0, -1, np.int32)
        self.gk_local = np.full(0, -1, np.int32)
        self.gk_counts = np.zeros(self.n, np.int64)
        self.gk_known = 0
        self._lut_dev = None      # (lut [Kg], inv [n, localK]) device pair
        self._lut_dirty = True
        # drained route-overflow lane: rows beyond quota so far
        self.route_overflow_rows = 0
        # routed step dispatches (each makes one exchange call when n > 1),
        # counted by the runtime where it dispatches, so a graph replay
        # counts as its eager step did
        self.dispatches = 0
        # K8 across processes (``pallas_ring`` with P > 1): the mapped
        # receive arenas, opened at the first dispatch of a column layout
        self._peer: Optional[PeerExchange] = None

    def peer_exchange(self) -> PeerExchange:
        """This layout's cross-process exchange state (made at first use)."""
        if self._peer is None:
            self._peer = PeerExchange(self.n, self.L, self.P, self.first // self.L)
        return self._peer

    def check_peer(self, what: str) -> None:
        """Raise ``ClusterPeerError`` if this layout's peer exchange has
        failed: its waits were released after a peer's death, so the
        step's rows came from a half no peer finished writing."""
        if self._peer is not None:
            self._peer.check(what)

    def close_peer(self, timeout_s=None) -> None:
        """Release the mapped arenas behind a barrier (every process of the
        group re-installs together)."""
        peer, self._peer = self._peer, None
        if peer is not None:
            peer.close(timeout_s)

    def _resize_gk(self, cap: int):
        if self.gk_owner.shape[0] >= cap:
            return
        grown_o = np.full(cap, -1, np.int32)
        grown_l = np.full(cap, -1, np.int32)
        grown_o[: self.gk_owner.shape[0]] = self.gk_owner
        grown_l[: self.gk_local.shape[0]] = self.gk_local
        self.gk_owner, self.gk_local = grown_o, grown_l

    def sync_gk(self, keyer) -> bool:
        """Assign per-shard local ids to group keys allocated since the
        last sync (allocation order per shard). Returns True while every
        shard still fits localK."""
        if not self.use_lut or keyer is None:
            return True
        total = len(keyer)
        if total <= self.gk_known and not self._lut_dirty:
            return int(self.gk_counts.max(initial=0)) <= self.localK
        self._resize_gk(max(total, self.n * self.localK))
        if total > self.gk_known:
            fresh = sorted(((gid, key) for key, gid in keyer._map.items()
                            if gid >= self.gk_known))
            for gid, key in fresh:
                owner = int(key[0]) % self.n   # composite keys lead with pk
                self.gk_owner[gid] = owner
                self.gk_local[gid] = self.gk_counts[owner]
                self.gk_counts[owner] += 1
            self.gk_known = total
            self._lut_dirty = True
        return int(self.gk_counts.max(initial=0)) <= self.localK

    def rebuild_gk(self, keyer):
        """Full LUT rebuild: local ids are a pure function of the keyer map."""
        self.gk_owner = np.full(0, -1, np.int32)
        self.gk_local = np.full(0, -1, np.int32)
        self.gk_counts = np.zeros(self.n, np.int64)
        self.gk_known = 0
        self._lut_dirty = True
        return self.sync_gk(keyer)

    def device_luts(self):
        """(lut, inv) on the device; refreshed only when the host LUT
        changed (steady state: no transfer)."""
        if self._lut_dev is not None and not self._lut_dirty:
            return self._lut_dev
        Kg = self.n * self.localK
        if self.use_lut:
            self._resize_gk(Kg)
            lut = np.where(self.gk_local[:Kg] >= 0,
                           self.gk_local[:Kg], 0).astype(np.int64)
            inv = np.zeros((self.n, self.localK), np.int64)
            alloc = np.nonzero(self.gk_local[:Kg] >= 0)[0]
            inv[self.gk_owner[alloc], self.gk_local[alloc]] = alloc
        else:
            lut = np.zeros(1, np.int64)
            inv = np.zeros((self.n, 1), np.int64)
        # two blocking copies from pageable memory, each its own span
        with span("sync.lut", rows=lut.shape[0]):
            lut_dev = torch.from_numpy(lut).to(self.device)
        with span("sync.lut", rows=inv.size):
            inv_dev = torch.from_numpy(inv).to(self.device)
        self._lut_dev = (lut_dev, inv_dev)
        self._lut_dirty = False
        return self._lut_dev

    def pk_positions(self, local: int) -> np.ndarray:
        """Routed row of global pk id g in a [n * local] key space."""
        g = np.arange(self.n * local, dtype=np.int64)
        return (g % self.n) * local + g // self.n

    def gk_positions(self) -> np.ndarray:
        """Routed row of global gk id g (bijective over [n * localK]):
        allocated ids sit at (owner, local); the rest fill the remaining
        all-init rows in order."""
        Kg = self.n * self.localK
        if not self.use_lut:
            return self.pk_positions(self.localK)
        self._resize_gk(Kg)
        pos = np.full(Kg, -1, np.int64)
        placed = np.nonzero(
            (self.gk_local[:Kg] >= 0) & (self.gk_local[:Kg] < self.localK))[0]
        pos[placed] = (self.gk_owner[placed].astype(np.int64) * self.localK
                       + self.gk_local[placed])
        free = np.setdiff1d(np.arange(Kg), pos[placed], assume_unique=False)
        pos[pos < 0] = free
        return pos

    def gk_inverse_values(self) -> np.ndarray:
        """[n, localK] local gk id -> global gk id (0 where unallocated)."""
        inv = np.zeros((self.n, self.localK), np.int64)
        Kg = self.n * self.localK
        self._resize_gk(Kg)
        placed = np.nonzero(
            (self.gk_local[:Kg] >= 0) & (self.gk_local[:Kg] < self.localK))[0]
        inv[self.gk_owner[placed], self.gk_local[placed]] = placed
        return inv


def route_ineligibility(runtime) -> Optional[str]:
    """Why this runtime cannot take the routed path (None = it can, else a
    ``core.eligibility.Reason``: free text with a stable ``.code``). The
    reference's classification, branch for branch and in its order:
    partitioned queries over keyed length windows (or no window),
    non-partitioned grouped queries without a window, and partitioned
    keyed-length stream-stream joins (``_join_route_ineligibility``).
    distinctCount/unionSet value tables ``[K, H]`` are keyed leaves and
    shard by key like the rest."""
    from siddhi_tpu_torch.core.eligibility import ReasonCode as RC
    from siddhi_tpu_torch.core.eligibility import reason
    from siddhi_tpu_torch.core.query.nfa_runtime import NFAQueryRuntime
    from siddhi_tpu_torch.ops.keyed_windows import KeyedLengthWindowStage

    if getattr(runtime, "sides", None) is not None:
        return _join_route_ineligibility(runtime)
    if isinstance(runtime, NFAQueryRuntime):
        return reason(RC.NFA_QUERY, "pattern/sequence (NFA) queries")
    if runtime.host_window is not None:
        return reason(RC.HOST_WINDOW, "host-mode windows")
    sp = runtime.selector_plan
    if sp.order_by or sp.limit is not None or sp.offset is not None:
        return reason(RC.ORDER_LIMIT, "order by / limit (batch-global ordering)")
    win = runtime.window_stage
    if win is not None and not isinstance(win, KeyedLengthWindowStage):
        return reason(RC.WINDOW_NOT_GLOBAL_AWARE,
                      f"window stage {type(win).__name__} (emission-order "
                      f"keys not global-aware yet)")
    if win is not None and runtime.partition_ctx is None:
        return reason(RC.GLOBAL_WINDOW, "global (non-partitioned) windows")
    if runtime.partition_ctx is None and runtime.keyer is None:
        return reason(RC.UNKEYED, "unkeyed queries (nothing to route by)")
    if runtime.carried_pk:
        return reason(RC.INNER_PARTITION_STREAM, "inner partition '#stream' inputs")
    return None


def _join_route_ineligibility(runtime) -> Optional[str]:
    """The reference's join classification: a partitioned keyed-length
    stream-stream join routes. Both sides' keyed rings shard by the
    partition key through the same exchange, a row's probe surface (the
    other side's ring rows of ITS OWN key) is local to its owner shard,
    and the joined rows' emission-order keys (the trigger row's, stridden
    by the probe width) re-merge exactly."""
    from siddhi_tpu_torch.core.eligibility import ReasonCode as RC
    from siddhi_tpu_torch.core.eligibility import reason
    from siddhi_tpu_torch.ops.keyed_windows import KeyedLengthWindowStage

    if runtime.partition_ctx is None:
        return reason(RC.JOIN_UNPARTITIONED,
                      "non-partitioned joins (nothing to route by)")
    if runtime.keyer is not None:
        return reason(RC.GROUPED_SELECT,
                      "grouped join selectors (host keyed select between stages)")
    sp = runtime.selector_plan
    if sp.order_by or sp.limit is not None or sp.offset is not None:
        return reason(RC.ORDER_LIMIT, "join order by / limit (batch-global ordering)")
    if runtime.index_probe is not None:
        return reason(RC.INDEXED_PROBE, "indexed join probes")
    for side in runtime.sides.values():
        if side.store is not None or side.host_window is not None:
            return reason(RC.STORE_SIDE,
                          f"shared-store/host-window join side '{side.stream_id}'")
        if side.global_side:
            return reason(RC.GLOBAL_SIDE, "global (non-partitioned) join sides")
        if not isinstance(side.window_stage, KeyedLengthWindowStage):
            return reason(RC.WINDOW_NOT_GLOBAL_AWARE,
                          f"join window stage {type(side.window_stage).__name__} "
                          f"(emission-order keys not global-aware yet)")
    return None


def _release_from_fanout(runtime):
    """A routed or sharded step owns the runtime's dispatch: a fused
    fan-out group (core/query/fused_fanout.py) would keep stepping the
    member through its unrouted fused step, so hand the member back its own
    junction subscription before installing the new one."""
    group = getattr(runtime, "_fanout_group", None)
    if group is not None:
        group.release(runtime)


def _check_mesh(runtime, mesh: Mesh) -> None:
    if mesh.device is not None and mesh.device != runtime.device:
        raise ValueError(
            f"mesh device {mesh.device} differs from the runtime's "
            f"{runtime.device}")
    if mesh.process_count > 1:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a mesh over several processes needs the process group: "
                "call parallel.distributed.initialize_cluster first")
        if (dist.get_world_size() != mesh.process_count
                or dist.get_rank() != mesh.process_index):
            raise ValueError(
                f"mesh of {mesh.process_count} processes (this one "
                f"{mesh.process_index}) does not match the process group "
                f"({dist.get_world_size()}, rank {dist.get_rank()})")


def device_route_query_step(runtime, mesh: Mesh, rows_per_shard: int = 4096,
                            exchange: Optional[str] = None):
    """Install routed execution over ``mesh`` for a keyed query (see the
    module doc). ``rows_per_shard`` bounds each shard's per-batch receive
    capacity; the host pre-checks per-pair quotas and SPLITS oversized
    batches (``prepare_routed_batches``), and a device-side overflow (rows
    beyond quota, only reachable by direct step callers) surfaces as
    ``FatalQueryError`` naming ``rows_per_shard``.

    Returns ``(step3, state)``; ``step3(state, cols, now)`` (the step
    instrument around the routed step) is also installed as
    ``runtime._step`` so junction-fed batches take the routed path. A join
    builds one routed step a side at its first batch (``step3`` None)."""
    why = route_ineligibility(runtime)
    if why is not None:
        raise CompileError(
            f"query '{runtime.name}': device routing does not support "
            f"{why} — use shard_query_step for those")
    if exchange is None:
        exchange = getattr(runtime.app_context, "shard_exchange", "all_to_all")
    if exchange not in ("all_to_all", "pallas_ring"):
        raise ValueError(f"unknown shard exchange {exchange!r}")
    _check_mesh(runtime, mesh)
    _release_from_fanout(runtime)
    partitioned = runtime.partition_ctx is not None
    use_lut = partitioned and runtime.keyer is not None
    _install(runtime, RouteLayout(mesh, rows_per_shard, exchange, partitioned,
                                  use_lut, runtime.device))
    return runtime._step, runtime._state


def _install(runtime, layout: "RouteLayout") -> None:
    """Lay the runtime's live state out for ``layout`` (from its canonical
    form when it was routed or sharded before) and build its step; a
    re-install frees what it replaces (the old step's program-cache ref)."""
    if runtime._route_layout is not None:
        canonical = _canonical_tensors(runtime)
        old = runtime._route_layout
        old.close_peer(_timeout(runtime))
        Kg = old.n * old.localK
        Wg = old.n * old.local_win if old.local_win > 1 else runtime._win_keys
    else:
        Kg = runtime.selector_plan.num_keys
        Wg = runtime._win_keys
        canonical = runtime._state
    old_step = runtime._step if runtime._route_layout is not None else None
    _install_routed(runtime, layout, canonical, Kg, Wg)
    close = getattr(old_step, "close", None)
    if close is not None:
        close()


def _install_routed(runtime, layout: RouteLayout, canonical, Kg: int, Wg: int):
    """Size the per-shard capacities, (re)build the GK LUT, lay the
    canonical state out shard-major (this process's shards), and build the
    step. Joins build a routed step a side, and NFAs a step a stream,
    lazily at their next batch."""
    n = layout.n
    # a growth or a restore re-installs the same layout: its arenas go too
    layout.close_peer(_timeout(runtime))
    Kg = max(int(Kg), n)
    # floor 16 (the engine's minimum key capacity): a tiny localK would
    # collide with aggregator slot counts in _key_axis_of's size match
    layout.localK = max(16, _pow2_div(Kg, n))
    if layout.partitioned:
        Wg = max(int(Wg), n)
        layout.local_win = max(16, _pow2_div(Wg, n))
    else:
        layout.local_win = 1
    # per-shard GK pressure can exceed localK under key skew even when the
    # global count fits — grow until the worst shard fits
    layout.rebuild_gk(runtime.keyer)
    while int(layout.gk_counts.max(initial=0)) > layout.localK:
        layout.localK *= 2
        layout._lut_dirty = True
    runtime.selector_plan.num_keys = layout.localK * (n if layout.sel_whole else 1)
    runtime._win_keys = layout.local_win
    runtime._route_layout = layout
    # the mesh bounds the runtime's pulls under cluster_step_timeout
    runtime._shard_mesh = layout.mesh
    runtime._instr_spec = None  # the route's meta slots join the spec
    runtime._state = None      # release the old layout before allocating
    runtime._state = _canonical_to_routed(runtime, layout, canonical)
    if getattr(runtime, "sides", None) is not None or hasattr(runtime, "build_timer_step_fn"):
        runtime._step = None
        getattr(runtime, "_steps", {}).clear()
        runtime.__dict__.get("_nfa_steps", {}).clear()
    else:
        runtime._step = routed_step_for(runtime)


def _pow2_div(total: int, n: int) -> int:
    """total/n rounded up to the next power of two."""
    k = 1
    need = (total + n - 1) // n
    while k < need:
        k *= 2
    return k


def _axes(layout: RouteLayout, path, leaf, shards: int) -> int:
    """Key axis of a leaf of a routed state holding ``shards`` shards (the
    process's ``L``, or all ``n`` once gathered); -1: unkeyed, stacked a
    shard along axis 0."""
    if layout.sel_whole and path and path[0] == "sel":
        return -1
    Kl, Wl = layout.localK, layout.local_win
    return _key_axis_of(path, leaf, shards * Kl, shards * Wl if Wl > 1 else 1)


# ---------------------------------------------------- key-sharded step

def _has_keyed_state(runtime) -> bool:
    keyed = []
    K, W = runtime.selector_plan.num_keys, runtime._win_keys

    def one(path, leaf):
        if _key_axis_of(path, leaf, K, W) >= 0:
            keyed.append(path)

    _map_tree(one, runtime._state)
    return bool(keyed)


def _split_mode(runtime) -> Optional[str]:
    """Where each process takes its own keys' rows in the key-sharded step
    across processes: at the step's input (partitioned queries, whose
    whole state is keyed by the partition key: a keyed window, a host
    window's per-key instances, the selector's groups, each group within
    one partition key) or at the selector's (a keyed selector behind a
    window whose ring every process keeps whole: a global window, or the
    ``delay`` window, whose ring has no key axis inside a partition
    either). None: the query runs whole on every process (an
    unpartitioned join or pattern: its state has no key axis, and a
    grouped selector keys the joined rows or matches on the host). Raises
    naming ROADMAP A.11 for a shape it cannot tell."""
    from siddhi_tpu_torch.core.query.nfa_runtime import NFAQueryRuntime
    from siddhi_tpu_torch.ops.host_windows import PartitionedHostWindow
    from siddhi_tpu_torch.ops.windows import DelayWindowStage

    what = None
    partitioned = runtime.partition_ctx is not None
    if getattr(runtime, "sides", None) is not None:
        if not partitioned:
            return None
        what = _join_split_ineligibility(runtime)
        if what is None:
            return "input"
    elif isinstance(runtime, NFAQueryRuntime):
        # a group by over captures keys the merged matches on the host and
        # selects on every process; an ordering without one runs once, on
        # the merged rows
        return "input" if partitioned else None
    elif partitioned:
        win, host = runtime.window_stage, runtime.host_window
        if host is not None and not isinstance(host, PartitionedHostWindow):
            what = f"the host window {type(host).__name__}"
        elif isinstance(win, DelayWindowStage):
            return "select"
        elif win is not None and not getattr(win, "split_aware", False):
            what = f"the window stage {type(win).__name__}"
        else:
            return "input"
    elif runtime.keyer is not None:
        return "select"
    raise NotImplementedError(
        f"query '{runtime.name}': shard_query_step across processes does "
        f"not split {what or 'this shape'} yet (ROADMAP A.11)")


def _join_split_ineligibility(runtime) -> Optional[str]:
    """What keeps a partitioned join from splitting at the input (None:
    it splits). Each side's keyed ring shards by the partition key, a
    row's probe surface (the other side's rows of its own key) is its own
    process's, and the matches merge by the unsharded (trigger row, slot)
    order. An aggregation groups the joined rows by partition key (the
    step keys them so), so its state splits with the rest; a group by
    selects on every process with the selector's state whole after the
    merge; an ordering alone runs once on the merged rows. A global side
    copies each row to every global key (each process keeps its own keys'
    copies). A store side (a table, or an incremental aggregation defined
    outside the partition) is whole on every process, since every process
    sees every event, and each trigger row probes it on its owner process;
    an aggregation's per-event ``within``/``per`` groups the batch's rows
    alike on every process, one probe a group, and its indexed probe's
    width comes from the whole buckets."""
    for side in runtime.sides.values():
        if side.host_window is not None:
            return f"the host-window join side '{side.stream_id}'"
        if side.store is None and not getattr(side.window_stage, "split_aware", False):
            return f"the join window stage {type(side.window_stage).__name__}"
    return None


def shard_query_step(runtime, mesh: Mesh, donate: bool = True):
    """The key-sharded step of a query with a replicated batch (the
    reference's GSPMD step). Every process sees every event; keyed state
    shards by key over the mesh's processes, state with no key axis stays
    whole on each, and every process emits the whole output in the
    unsharded order. Returns ``(step, state)``.

    On a one-process mesh (``make_mesh(n)``, ``local_survivor_mesh()``)
    the state stays whole: n logical shards of one card share one memory,
    so there is nothing to gather (the reference's ``_out_shardings``
    returning None). The mesh is recorded (``runtime._shard_mesh``), so
    ``siddhi_tpu.cluster_step_timeout`` bounds the runtime's pulls, and
    capacity growth re-invokes this function.

    Across processes each process keeps its own keys' rows of every keyed
    leaf (one shard a process), steps the batch over them, and the emitted
    rows are gathered (one ``all_gather``) and merged once by a global
    emission-order key. A query with no keyed state runs whole on every
    process, and so does an unpartitioned join or pattern: it has no key
    axis to split (its rings and match slots are the stream's, and a
    grouped selector keys the joined rows or matches on the host).
    ``donate`` is the reference's; the port's steps update their state in
    place whatever it says. A shape it cannot tell raises
    ``NotImplementedError`` naming ROADMAP A.11."""
    from siddhi_tpu_torch.core.query.nfa_runtime import NFAQueryRuntime

    _check_mesh(runtime, mesh)
    _release_from_fanout(runtime)
    if runtime._state is None:
        runtime._state = runtime._init_state()
    partitioned = runtime.partition_ctx is not None
    mode = (None if mesh.process_count == 1 or (runtime._route_layout is None
                                                and not _has_keyed_state(runtime))
            else _split_mode(runtime))
    if mode is None:
        runtime._shard_mesh = mesh
        return runtime._step, runtime._state
    # a group by over a pattern's captures or a join's joined rows: the
    # selector runs whole after the merge; any other group key than the
    # partition key is carried to the owner's local space through the
    # layout's LUT, as routed. Split at the selector, no input row moves,
    # and the window keeps no key axis
    sel_whole = (runtime.keyer is not None
                 and (isinstance(runtime, NFAQueryRuntime)
                      or getattr(runtime, "sides", None) is not None))
    by_input = partitioned and mode == "input"
    _install(runtime, RouteLayout(mesh, 4096, "all_to_all", by_input,
                                  by_input and runtime.keyer is not None
                                  and not sel_whole,
                                  runtime.device, split=mode, sel_whole=sel_whole))
    if runtime.host_window is not None:
        runtime.host_window.key_split = (runtime._route_layout.n,
                                         runtime._route_layout.first)
    return runtime._step, runtime._state


# ---------------------------------------------- the legacy host router

def route_batch_to_shards(cols, n_shards: int, rows_per_shard: int):
    """Host-side all-to-all: scatter batch rows to their owning key shard.

    DEPRECATED — a compatibility shim kept for the legacy
    ``shard_keyed_query_step`` callers. The host router moves every row
    through numpy before the step and requires GK == PK; new code should
    use :func:`device_route_query_step`, which routes rows inside the step
    (one exchange launch), supports a group-by key distinct from the
    partition key, and re-merges emitted rows into the exact unsharded
    order.

    The owner of dense key ``k`` is ``k % n_shards`` and its local id is
    ``k // n_shards``. Returns a routed column dict of shape
    ``[n_shards * rows_per_shard]`` where segment ``d`` holds shard
    ``d``'s rows (original order kept within the shard) padded with
    invalid rows, and the PK/GK columns rewritten to LOCAL ids."""
    import time
    import warnings

    from siddhi_tpu_torch.core.stream.junction import FatalQueryError
    from siddhi_tpu_torch.observability.telemetry import global_registry

    warnings.warn(
        "route_batch_to_shards is deprecated: use device_route_query_step "
        "(on-device repartitioning; lifts the GK == PK restriction)",
        DeprecationWarning, stacklevel=2)
    t0 = time.perf_counter()
    key_col = PK_KEY if PK_KEY in cols else GK_KEY
    if GK_KEY in cols and PK_KEY in cols and not np.array_equal(
            np.asarray(cols[GK_KEY]), np.asarray(cols[PK_KEY])):
        # a group-by key distinct from the partition key lives in its own
        # dense-id space: the device router carries the two apart
        raise FatalQueryError(
            "route_batch_to_shards requires GK == PK (partitioned query "
            "without a distinct group-by key) — device_route_query_step "
            "lifts this restriction")
    valid = np.asarray(cols[VALID_KEY])
    keep = np.nonzero(valid)[0]  # capacity padding never competes for rows
    pk = np.asarray(cols[key_col]).astype(np.int64)[keep]
    owner = pk % n_shards
    local = pk // n_shards
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n_shards)
    if int(counts.max(initial=0)) > rows_per_shard:
        raise FatalQueryError(
            f"shard overflow: {int(counts.max())} rows for one shard > "
            f"rows_per_shard={rows_per_shard} — raise rows_per_shard or "
            f"split the batch")
    starts = np.zeros(n_shards, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    owner_sorted = owner[order]
    pos = np.arange(keep.shape[0], dtype=np.int64) - starts[owner_sorted]
    dest = owner_sorted * rows_per_shard + pos
    src = keep[order]

    N = n_shards * rows_per_shard
    routed = {}
    for k, v in cols.items():
        v = np.asarray(v)
        if k in (PK_KEY, GK_KEY):
            buf = np.zeros(N, v.dtype)
            buf[dest] = local[order].astype(v.dtype)
        else:
            buf = np.zeros((N,) + v.shape[1:], v.dtype)
            buf[dest] = v[src]
        routed[k] = buf
    _record_route_telemetry(global_registry(), "host", counts,
                            (time.perf_counter() - t0) * 1000.0)
    return routed  # padding rows keep VALID=False (zero-fill)


def shard_keyed_query_step(runtime, mesh: Mesh, rows_per_shard: int):
    """A keyed (partitioned) query's step over ``mesh``'s shards, each
    stepping its own key slice of the state over its own rows: the
    deprecated shim behind ``route_batch_to_shards``.

    The runtime is sized to its PER-SHARD key capacity
    (``selector_plan.num_keys`` / ``_win_keys`` are local values), and
    batches arrive routed (``[n * rows_per_shard]`` rows carrying local key
    ids). Global-window queries cannot take this path (their ring
    semantics need every row in order); use ``shard_query_step`` for
    those. The mesh's shards share this process's device (the reference's
    ``shard_map`` over devices); across processes use
    ``device_route_query_step``.

    Returns ``(step, global_state)``: ``step(state, routed_cols, now)``.
    Out rows come back shard-segmented (leaf axis 0 = ``n * R_local``);
    ``"__meta__"`` is ``[n, 3 + lanes]``, one (overflow, notify, count)
    row per shard, then the step's instrument lanes."""
    if mesh.process_count > 1:
        raise ValueError(
            f"query '{runtime.name}': shard_keyed_query_step steps the shards "
            f"of one process; across {mesh.process_count} processes use "
            f"device_route_query_step")
    _release_from_fanout(runtime)
    n = mesh.n
    localK = runtime.selector_plan.num_keys
    local_win = runtime._win_keys
    if runtime._state is None:
        runtime._state = runtime._init_state()
    step = runtime.build_step_fn()
    axes = _map_tree(lambda path, leaf: _key_axis_of(path, leaf, localK, local_win),
                     runtime._state)

    def stack_global(_path, leaf, ax):
        # an unkeyed leaf: a leading shard axis, every shard its own copy
        return (torch.stack([leaf] * n, dim=0) if ax < 0
                else torch.cat([leaf] * n, dim=ax))

    global_state = _map_tree(stack_global, runtime._state, axes)

    def view(_path, leaf, ax, s):
        if ax < 0:
            return leaf[s]
        size = leaf.shape[ax] // n
        return leaf.narrow(ax, s * size, size)

    def sharded(state, cols, now):
        outs = []
        for s in range(n):
            views = _map_tree(lambda p, leaf, ax: view(p, leaf, ax, s), state, axes)
            held = _map_tree(lambda _p, t: t, views)
            rows = {k: v[s * (v.shape[0] // n):(s + 1) * (v.shape[0] // n)]
                    for k, v in cols.items()}
            new_state, out = step(views, rows, now)
            _write_back(held, new_state)
            outs.append(out)
        return state, {k: torch.cat([o[k].reshape(1, *o[k].shape) if (
            k == "__meta__" or o[k].dim() == 0) else o[k] for o in outs])
            for k in outs[0]}

    jitted = runtime.app_context.telemetry.instrument_jit(
        sharded, f"query.{runtime.name}.shard_map_step",
        family="shard_map_routed", cache_extra=str(mesh))
    dev = runtime.device

    def routed_step(state, cols, now):
        # the routed batch (the router's host columns, or tensors) on the
        # runtime's device, before the step
        cols = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))).to(dev) for k, v in cols.items()}
        return jitted(state, cols, int(now))

    return routed_step, global_state


# -------------------------------------------------------- state relayout

def _gather_shards(layout: RouteLayout, state, timeout_s=None):
    """This process's shards of a routed state -> all n shards (every
    process's, in process order: one ``all_gather`` of the packed
    leaves)."""
    from siddhi_tpu_torch.ops.exchange import all_gather_same

    paths, leaves = [], []

    def collect(path, leaf):
        paths.append(path)
        leaves.append(leaf)

    _map_tree(collect, state)
    gathered = dict(zip(paths, all_gather_same(leaves, timeout_s, "state gather")))
    # mapped over the state itself, so an empty subtree (a selector with
    # no aggregator) keeps its place
    return _map_tree(lambda path, leaf: torch.cat(
        gathered[path], dim=max(_axes(layout, path, leaf, layout.L), 0)), state)


def _canonical_tensors(runtime):
    """Routed (shard-major) state -> canonical unsharded layout, as
    tensors on the runtime's device. Across processes every process's
    shards are gathered first, so every process holds the whole."""
    layout = runtime._route_layout
    n, Kl = layout.n, layout.localK
    dev = runtime.device
    state = (runtime._state if layout.L == n
             else _gather_shards(layout, runtime._state, _timeout(runtime)))
    pos_gk = torch.from_numpy(layout.gk_positions()).to(dev)
    inv_gk_vals = (torch.from_numpy(layout.gk_inverse_values()).to(dev)
                   if layout.use_lut else None)

    def one(path, leaf):
        ax = _axes(layout, path, leaf, n)
        if ax < 0:
            return leaf[0].clone() if leaf.dim() else leaf.clone()
        idcol = _buffered_id_col(path)
        if idcol is not None:
            # buffered LOCAL key ids -> global before the rows move: ring
            # rows of shard s live in block s of the flat ring
            blocks = leaf.view(n, -1).to(torch.int64)
            s = torch.arange(n, device=dev)[:, None]
            if idcol == "pk" or inv_gk_vals is None:
                glob = blocks * n + s
            else:
                glob = inv_gk_vals[s, torch.clamp(blocks, 0, Kl - 1)]
            leaf = glob.reshape(-1).to(leaf.dtype)
        if _leaf_space(path) == "gk":
            return leaf.index_select(ax, pos_gk)
        keys = n * layout.local_win
        pos = torch.from_numpy(layout.pk_positions(layout.local_win)).to(dev)
        return leaf.reshape(keys, -1)[pos].reshape(leaf.shape)

    return _map_tree(one, state)


def _canonical_nbytes(runtime) -> int:
    """Bytes of ``_canonical_tensors(runtime)``, from the routed state's
    metadata alone: a keyed leaf grows to all n shards, an unkeyed one
    keeps one shard's row."""
    layout = runtime._route_layout
    total = 0

    def one(path, leaf):
        nonlocal total
        nb = leaf.nbytes
        if leaf.dim() and _axes(layout, path, leaf, layout.L) < 0:
            nb //= leaf.shape[0]
        elif leaf.dim():
            nb = nb * layout.n // layout.L
        total += nb

    _map_tree(one, runtime._state)
    return total


def canonical_route_state(runtime):
    """Routed state -> canonical unsharded layout, host-side numpy (the
    form the reference's snapshots and ``jax.device_get`` produce)."""
    return _map_tree(lambda _p, t: t.cpu().numpy(), _canonical_tensors(runtime))


def _canonical_to_routed(runtime, layout: RouteLayout, canonical):
    """Canonical state (numpy or tensors, possibly smaller capacity) ->
    routed shard-major layout at the layout's capacities, this process's
    shards only; missing key rows come from init."""
    n = layout.n
    local_init = runtime._init_state()

    def stack(path, leaf):
        ax = _axes(layout, path, leaf, 1)
        if ax < 0:
            return torch.stack([leaf] * n, dim=0)
        return torch.cat([leaf] * n, dim=ax)

    routed = _map_tree(stack, local_init)
    del local_init
    if canonical is not None:
        routed = _fill_routed(runtime, layout, routed, canonical)
    if layout.L == n:
        return routed
    first, L = layout.first, layout.L

    def mine(path, leaf):
        ax = _axes(layout, path, leaf, n)
        if ax < 0:
            return leaf[first:first + L].clone()
        size = leaf.shape[ax] // n
        return leaf.narrow(ax, first * size, L * size).clone()

    return _map_tree(mine, routed)


def _fill_routed(runtime, layout: RouteLayout, routed, canonical):
    """Copy the canonical state's rows into a full (n-shard) routed
    layout."""
    n, Kl, Wl = layout.n, layout.localK, layout.local_win
    dev = runtime.device
    pos_gk_np = layout.gk_positions()
    if layout.use_lut:
        layout._resize_gk(n * Kl)

    def one(path, out, canon):
        canon = torch.as_tensor(np.asarray(canon) if not isinstance(
            canon, torch.Tensor) else canon).to(dev)
        ax = _axes(layout, path, out, n)
        if ax < 0:
            if layout.sel_whole and path[0] == "sel":
                # a whole selector state at the layout's capacity: the
                # canonical rows of its keys, the rest from init
                whole = out[0].clone()
                cut = tuple(slice(0, min(a, b)) for a, b in zip(whole.shape, canon.shape))
                whole[cut] = canon[cut].to(whole.dtype)
                canon = whole
            return torch.stack([canon] * n, dim=0)
        if _leaf_space(path) == "gk":
            g = np.arange(min(canon.shape[ax], n * Kl))
            if layout.use_lut:
                # only groups ALIVE in the (rebuilt-from-keyer) LUT carry
                # their canonical rows over
                g = g[layout.gk_local[g] >= 0]
            src = torch.from_numpy(g).to(dev)
            dst = torch.from_numpy(pos_gk_np[g]).to(dev)
            out.index_copy_(ax, dst, canon.index_select(ax, src).to(out.dtype))
            return out
        # key-major rows: a flat ring's [Kw*W] or an NFA's [K, S]
        keys = n * Wl
        W = out.numel() // keys
        rows = canon.reshape(-1, W) if W else canon.reshape(canon.shape[0], 0)
        ng = min(rows.shape[0], keys)
        pos = torch.from_numpy(layout.pk_positions(Wl)[:ng]).to(dev)
        out.view(keys, W)[pos] = rows[:ng].to(out.dtype)
        idcol = _buffered_id_col(path)
        if idcol is not None:
            # buffered GLOBAL key ids -> this layout's locals
            vals = out.to(torch.int64)
            if idcol == "pk" or not layout.use_lut:
                loc = vals // n
            else:
                lut_g = torch.from_numpy(np.where(
                    layout.gk_local[: n * Kl] >= 0,
                    layout.gk_local[: n * Kl], 0).astype(np.int64)).to(dev)
                loc = lut_g[torch.clamp(vals, 0, lut_g.shape[0] - 1)]
            out.copy_(loc.to(out.dtype))
        return out

    return _map_tree(one, routed, canonical)


# ----------------------------------------------------------- routed step

def _shard_views(layout: RouteLayout, state, s: int):
    """Views of this process's shard ``s`` (local index) of every routed
    state tensor."""
    L = layout.L

    def view(path, leaf):
        ax = _axes(layout, path, leaf, L)
        if ax < 0:
            return leaf[s]
        size = leaf.shape[ax] // L
        return leaf.narrow(ax, s * size, size)

    return _map_tree(view, state)


def _write_back(views, new) -> None:
    """A step that hands back new tensors for state leaves (the NFA's)
    instead of updating its views in place: copy them into the views."""
    if isinstance(views, dict):
        for k, v in views.items():
            if isinstance(new, dict) and k in new:
                _write_back(v, new[k])
        return
    if isinstance(new, torch.Tensor) and new is not views:
        views.copy_(new)


def _step_on_shard(layout: RouteLayout, step, state, s: int, *args, **kwargs):
    """``step`` over views of local shard ``s``; state it hands back anew
    is written into the shard's rows."""
    views = _shard_views(layout, state, s)
    held = _map_tree(lambda _p, t: t, views)   # the views, before the step
    new_state, out = step(views, *args, **kwargs)
    _write_back(held, new_state)
    return out


def step_on_own_shard(layout: RouteLayout, step, state, *args):
    """``step(views, *args) -> (new sub-state, out)`` over this process's
    one shard of a key-sharded state across processes (the host keyed
    select's whole selector state, ``QueryRuntime._host_keyed_select``):
    ``step`` hands back the state of the tree's ``"sel"`` subtree."""
    def run(views, *a):
        new_sel, out = step(views, *a)
        return {"sel": new_sel}, out

    return _step_on_shard(layout, run, state, 0, *args)


def routed_step_for(runtime, side_key: Optional[str] = None):
    """Build the routed ``step3(state, cols, now)`` for a runtime whose
    ``_route_layout`` is installed, through the step instrument under
    family ``device_routed`` with the layout as its extra witness: on the
    card a capturable routed step (a keyed length window or none, and the
    exchange kernel) replays as one CUDA graph a dispatch, and equal
    routed programs of two apps share one program-cache entry.
    ``side_key`` builds one side of a routed join (the side's insert and
    probe step routes like any keyed step: both sides' rings shard by the
    partition key, so a routed row's probe surface is local to its owner
    shard). The key-sharded step with a replicated batch
    (``shard_query_step`` across processes) takes family
    ``gspmd_replicated_batch``."""
    import time

    t0 = time.perf_counter()
    layout = runtime._route_layout
    extra = (f"n={layout.n} quota={layout.quota} localK={layout.localK} "
             f"local_win={layout.local_win} partitioned={layout.partitioned} "
             f"use_lut={layout.use_lut} processes={layout.P} split={layout.split}")
    if layout.split:
        fn = _split_fn(runtime, layout, side_key)
        if side_key is not None:
            return runtime.app_context.telemetry.instrument_jit(
                fn, f"join.{runtime.name}.{side_key}.sharded_step",
                family="gspmd_replicated_batch", cache_extra=extra)
        return runtime.instrument_step(
            fn, f"query.{runtime.name}.sharded_step",
            family="gspmd_replicated_batch", cache_extra=extra,
            build_ms=(time.perf_counter() - t0) * 1000.0)
    fn = _routed_fn(runtime, layout, side_key)
    if side_key is not None:
        # the join's side steps read their match counts back: eager, as
        # its unrouted side steps (analysis/step_registry.py)
        return runtime.app_context.telemetry.instrument_jit(
            fn, f"join.{runtime.name}.{side_key}",
            family=f"device_routed.{side_key}", cache_extra=extra)
    return runtime.instrument_step(
        fn, f"query.{runtime.name}.step", family="device_routed",
        cache_extra=extra, build_ms=(time.perf_counter() - t0) * 1000.0)


def _timeout(runtime):
    """The app's bound on a collective's wait (``siddhi_tpu.
    cluster_step_timeout``), read at each step; None: unbounded."""
    return getattr(runtime.app_context, "cluster_step_timeout", None)


def _exchange(layout: RouteLayout, sent, timeout_s=None, what="shard exchange"):
    """Move every column's send buckets to their owners: ``sent[i]`` is
    ``[L, n*Q, *tail]`` (this process's source shards; segment d bound
    for global shard d). On one process, one ``ring_exchange_cols`` call;
    across processes K8's peer writes under ``pallas_ring``, else the own
    pairs through the kernel and the rest through the group's collective.
    Returns ``[L, n*Q, *tail]`` per column: this process's shards' receive
    buffers, source-major over all n sources."""
    n, L = layout.n, layout.L
    if layout.P == 1:
        return ring_exchange_cols(sent, n)
    if layout.exchange == "pallas_ring":
        return peer_exchange_cols(sent, layout.peer_exchange(), timeout_s, what)
    return process_exchange_plain(sent, n, L, layout.first // L, timeout_s, what)


def _egress(layout: RouteLayout, merged: dict, okey, meta, rows_here, route_ov,
            ins_on: bool, inner_slots, timeout_s=None, what: str = "egress"):
    """The ordered re-merge and the packed meta: this process's emitted
    rows (with every other process's: one ``all_gather``) sorted once by
    their global emission-order key (invalid rows last), and
    ``[overflow, notify, count, route_overflow, rows_0..rows_n-1,
    residual?, inner lanes]`` from every shard's meta."""
    n, Q = layout.n, layout.quota
    if layout.P > 1:
        from siddhi_tpu_torch.ops.exchange import all_gather_rows, all_gather_same

        sig = torch.tensor([_schema_sig(merged)], dtype=torch.int64, device=okey.device)
        metas, counts, ovs, sigs = all_gather_same(
            [meta, rows_here, route_ov.reshape(1), sig], timeout_s, what)
        meta = torch.cat(metas)
        rows_here = torch.cat(counts)
        route_ov = torch.cat(ovs).sum()
        if any(not torch.equal(sg, sigs[0]) for sg in sigs):
            merged = _union_schema(merged, okey.shape[0])
        names = sorted(merged)
        rows = all_gather_rows([merged[k] for k in names] + [okey], timeout_s, what)
        merged = {k: torch.cat(rows[i]) for i, k in enumerate(names)}
        okey = torch.cat(rows[-1])
    order = torch.argsort(okey, stable=True)
    merged = {k: v[order] for k, v in merged.items()}
    ov = meta[0, 0]
    for lane in meta[1:, 0]:
        ov = ov | lane      # a join's lane is a bitmask of knobs
    ntb = torch.where(meta[:, 1] < 0, torch.full_like(meta[:, 1], _ROUTE_BIG),
                      meta[:, 1]).min()
    nt = torch.where(ntb >= _ROUTE_BIG, torch.full_like(ntb, -1), ntb)
    cnt = meta[:, 2].sum()
    parts = [torch.stack([ov, nt, cnt, route_ov.to(torch.int64)]),
             rows_here.to(torch.int64)]
    if ins_on:
        # the receive capacity left on the fullest shard this batch
        # (0: one more skewed batch overflows)
        parts.append(n * Q - rows_here.max().reshape(1).to(torch.int64))
    lane = 3
    for slot in inner_slots:
        v = meta[:, lane:lane + slot.width]
        lane += slot.width
        parts.append(v.max(dim=0).values if slot.reduce == "max" else v.sum(dim=0))
    merged["__meta__"] = torch.cat(parts)
    return merged


def _schema_of(cols: dict) -> dict:
    """name -> (dtype, trailing shape) of row-aligned columns."""
    return {k: (str(v.dtype), tuple(v.shape[1:])) for k, v in cols.items()}


def _schema_sig(cols: dict) -> int:
    """A checksum of the columns' names, dtypes and trailing shapes."""
    import zlib

    return zlib.crc32(repr(sorted(_schema_of(cols).items())).encode())


def _union_schema(cols: dict, rows: int) -> dict:
    """``cols`` with every column another process emits and this one does
    not (a stage may emit fewer columns when it emits no row), as zeros of
    ``rows`` rows: every process's rows then pack alike. One
    ``all_gather_object`` of the schemas, only when they differ."""
    import torch.distributed as dist

    schemas = [None] * dist.get_world_size()
    dist.all_gather_object(schemas, _schema_of(cols))
    dev = next(iter(cols.values())).device
    out = dict(cols)
    for schema in schemas:
        for k, (dt, tail) in schema.items():
            if k not in out:
                out[k] = torch.zeros((rows,) + tuple(tail),
                                     dtype=getattr(torch, dt.split(".")[-1]), device=dev)
    return out


def _routed_fn(runtime, layout: "RouteLayout", side_key: Optional[str] = None):
    n, Q, L, first = layout.n, layout.quota, layout.L, layout.first
    localK = layout.localK
    partitioned, use_lut = layout.partitioned, layout.use_lut
    if side_key is not None:
        side_step = runtime.build_side_step_fn(side_key)

        def step(state, cols, now):
            # the probe surfaces live in the routed state (keyed rings)
            return side_step(state, {}, None, cols, now)
    else:
        step = runtime.build_step_fn()
    key_name = PK_KEY if partitioned else GK_KEY
    dev = runtime.device
    # device instruments (observability/instruments.py): the inner step
    # appends its own lanes a shard; the routed step adds the exchange
    # residual and folds each inner lane across the shards by its slot's
    # reduce (sum for counts a shard owns, max for fill levels). Read at
    # build, so the meta matches runtime.instrument_slots()
    ins_on = runtime._instruments_on()
    inner_slots = runtime._step_instrument_slots()

    if n == 1:
        def one_dev(state, cols, now):
            cols = dict(cols)
            cols.pop(LUT_KEY, None)     # one shard: local ids are global
            cols.pop(INV_KEY, None)
            B = cols[VALID_KEY].shape[0]
            cols[RIDX_KEY] = torch.arange(B, dtype=torch.int64, device=dev)
            rows = cols[VALID_KEY].sum(dtype=torch.int64)
            out = dict(_step_on_shard(layout, step, state, 0, cols, now))
            meta = out.pop("__meta__")
            out.pop(OKEY_KEY, None)   # single shard: already in order
            parts = [meta[:3], torch.zeros(1, dtype=torch.int64, device=dev), rows[None]]
            if ins_on:
                parts.append(n * Q - rows[None])
            parts.append(meta[3:])    # the inner step's lanes
            out["__meta__"] = torch.cat(parts)
            return state, out

        return one_dev

    def step3(state, cols, now):
        cols = dict(cols)
        lut, inv = cols.pop(LUT_KEY, None), cols.pop(INV_KEY, None)
        if use_lut and lut is None:     # a direct caller: the layout's own
            lut, inv = layout.device_luts()
        B = cols[VALID_KEY].shape[0]
        Bl = B // n
        # this process's source slices of the (replicated) batch
        lo, hi = first * Bl, (first + L) * Bl
        valid = cols[VALID_KEY][lo:hi].view(L, Bl)
        ridx = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        # owner shard per row (invalid rows route nowhere: owner = n)
        owner = torch.where(valid, cols[key_name][lo:hi].view(L, Bl).to(torch.int64) % n,
                            torch.full((L, Bl), n, dtype=torch.int64, device=dev))
        dest = torch.arange(n, dtype=torch.int64, device=dev)[None, :, None]
        maskd = owner[:, None, :] == dest                         # [src, dst, Bl]
        pos = torch.cumsum(maskd.to(torch.int64), dim=2) - 1
        owner_c = torch.clamp(owner, 0, n - 1)
        pos_row = torch.gather(pos, 1, owner_c[:, None, :]).squeeze(1)  # [L, Bl]
        sendable = owner < n
        sent_row = sendable & (pos_row < Q)
        route_ov = (sendable & ~sent_row).sum(dtype=torch.int64)
        src = torch.arange(L, dtype=torch.int64, device=dev)[:, None]
        # one flat send buffer per column: source s's segment d starts at
        # s*n*Q + d*Q; unsent rows land in one trailing dump slot
        slot = torch.where(sent_row, src * (n * Q) + owner * Q + pos_row,
                           torch.full_like(pos_row, L * n * Q)).reshape(-1)

        def pack(col):
            tail = tuple(col.shape[1:])
            buf = torch.zeros((L * n * Q + 1,) + tail, dtype=col.dtype, device=dev)
            buf[slot] = col
            return buf[: L * n * Q].view((L, n * Q) + tail)

        # every column and the row index in ONE exchange call
        sent = [pack(v[lo:hi]) for v in cols.values()] + [pack(ridx)]
        what = f"query '{runtime.name}' routed step"
        rcols = dict(zip([*cols, RIDX_KEY],
                         _exchange(layout, sent, _timeout(runtime), what)))
        rows_here = rcols[VALID_KEY].sum(dim=1, dtype=torch.int64)   # [L]
        # global -> per-shard local ids (two separate dense spaces)
        if partitioned:
            pk = rcols[PK_KEY]
            rcols[PK_KEY] = (pk.to(torch.int64) // n).to(pk.dtype)
        gk = rcols[GK_KEY]
        if use_lut:
            gl = lut[torch.clamp(gk.to(torch.int64), 0, lut.shape[0] - 1)]
            gl = torch.clamp(gl, 0, localK - 1)
        else:
            gl = gk.to(torch.int64) // n
        rcols[GK_KEY] = gl.to(gk.dtype)

        outs, okeys, metas = [], [], []
        for s in range(L):
            g = first + s             # the shard's global index
            out = dict(_step_on_shard(layout, step, state, s,
                                      {k: v[s] for k, v in rcols.items()}, now))
            metas.append(out.pop("__meta__"))
            okey = out.pop(OKEY_KEY).to(torch.int64)
            okeys.append(torch.where(out[VALID_KEY], okey,
                                     torch.full_like(okey, _ROUTE_BIG)))
            # local -> global ids on the emitted rows
            if partitioned and PK_KEY in out:
                pko = out[PK_KEY]
                out[PK_KEY] = (pko.to(torch.int64) * n + g).to(pko.dtype)
            if GK_KEY in out:
                gko = out[GK_KEY]
                if use_lut:
                    gg = inv[g, torch.clamp(gko.to(torch.int64), 0, localK - 1)]
                else:
                    gg = gko.to(torch.int64) * n + g
                out[GK_KEY] = gg.to(gko.dtype)
            outs.append(out)
        merged = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        out = _egress(layout, merged, torch.cat(okeys), torch.stack(metas), rows_here,
                      route_ov, ins_on, inner_slots, _timeout(runtime), what)
        layout.check_peer(what)
        return state, out

    return step3


def _split_fn(runtime, layout: RouteLayout, side_key: Optional[str] = None):
    """The key-sharded step with a replicated batch, one shard a process:
    this process's keys' rows (``key % n == first``) take its state, at
    the step's input or at the selector's (``layout.split``), and the
    emitted rows merge across processes by their global order: the input
    rows' positions, a keyed window's order keys over the global key
    space (``ops/keyed_windows.KeySplit``), or a partitioned host window's
    (``PartitionedHostWindow.key_split``). An order by / limit / offset
    runs once, on the merged rows, unless the whole selector does
    (``layout.sel_whole``). ``side_key`` builds one side of a partitioned
    join (its insert and probe split like any keyed step)."""
    from siddhi_tpu_torch.core.plan.selector_plan import STR_RANK
    from siddhi_tpu_torch.ops.exchange import all_gather_rows, all_gather_same
    from siddhi_tpu_torch.ops.keyed_windows import KeySplit

    n, first = layout.n, layout.first
    partitioned, use_lut, localK = layout.partitioned, layout.use_lut, layout.localK
    dev = runtime.device
    ins_on = runtime._instruments_on()
    inner_slots = runtime._step_instrument_slots()
    select = layout.split == "select"
    plan = runtime.selector_plan
    post_order = plan.ordered and not layout.sel_whole
    what = f"query '{runtime.name}' sharded step"

    def take(cols):
        # behind a global window: the rows of other processes' groups
        # skip this process's selector state (they emit there)
        gk = cols[GK_KEY].to(torch.int64)
        t = cols[TYPE_KEY]
        data = (t == 0) | (t == 1)            # CURRENT | EXPIRED
        cols[VALID_KEY] = cols[VALID_KEY] & ((gk % n == first) | ~data)
        cols[GK_KEY] = (gk // n).to(cols[GK_KEY].dtype)
        return cols

    key_split = None if select else KeySplit(
        n, first, lambda t: all_gather_same([t], _timeout(runtime), what)[0],
        lambda t: all_gather_rows([t], _timeout(runtime), what)[0])
    if side_key is not None:
        side_step = runtime.build_side_step_fn(side_key, key_split=key_split)

        def step(state, cols, now, probe=({}, None), **kw):
            # the probe surfaces live in the state (keyed rings), or come
            # from a store side, whole on every process (``kw``: an
            # aggregation side's indexed-probe width)
            return side_step(state, probe[0], probe[1], cols, now, **kw)
    else:
        step = runtime.build_step_fn(split=take if select else None,
                                     key_split=key_split, unordered=plan.ordered)
    key_name = PK_KEY if partitioned else GK_KEY

    def sharded(state, cols, now, **probe):
        cols = dict(cols)
        lut, inv = cols.pop(LUT_KEY, None), cols.pop(INV_KEY, None)
        if use_lut and lut is None:     # a direct caller: the layout's own
            lut, inv = layout.device_luts()
        host_notify = cols.pop(HOST_NOTIFY_KEY, None)
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        owner = torch.where(valid, cols[key_name].to(torch.int64) % n,
                            torch.full((B,), n, dtype=torch.int64, device=dev))
        rows = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
            0, owner, torch.ones(B, dtype=torch.int64, device=dev))
        if not select:
            cols[VALID_KEY] = valid & (owner == first)
            if PK_KEY in cols:
                cols[PK_KEY] = (cols[PK_KEY].to(torch.int64) // n).to(cols[PK_KEY].dtype)
            if GK_KEY in cols:
                gk = cols[GK_KEY].to(torch.int64)
                if use_lut:
                    gl = torch.clamp(lut[torch.clamp(gk, 0, lut.shape[0] - 1)],
                                     0, localK - 1)
                else:
                    gl = gk // n
                cols[GK_KEY] = gl.to(cols[GK_KEY].dtype)
            cols[RIDX_KEY] = torch.arange(B, dtype=torch.int64, device=dev)
        out = dict(_step_on_shard(layout, step, state, 0, cols, now, **probe))
        meta = out.pop("__meta__")
        if host_notify is not None:
            # a host window's wake time joins the step's, so the merged
            # meta gives every process the same next timer
            nt = torch.where(meta[1] < 0, host_notify, torch.where(
                host_notify < 0, meta[1], torch.minimum(meta[1], host_notify)))
            meta = torch.cat([meta[:1], nt.reshape(1), meta[2:]])
        okey = out.pop(OKEY_KEY, None)
        if select or okey is None:
            # the selector is row-aligned with the window's emission, which
            # every process computes alike
            okey = torch.arange(out[VALID_KEY].shape[0], dtype=torch.int64, device=dev)
        okey = torch.where(out[VALID_KEY], okey.to(torch.int64),
                           torch.full_like(okey, _ROUTE_BIG, dtype=torch.int64))
        if PK_KEY in out and not select:
            pko = out[PK_KEY]
            out[PK_KEY] = (pko.to(torch.int64) * n + first).to(pko.dtype)
        if GK_KEY in out:
            gko = out[GK_KEY]
            if use_lut:
                gg = inv[first, torch.clamp(gko.to(torch.int64), 0, localK - 1)]
            else:
                gg = gko.to(torch.int64) * n + first
            out[GK_KEY] = gg.to(gko.dtype)
        merged = _egress(layout, out, okey, meta[None], rows[first:first + 1],
                         torch.zeros((), dtype=torch.int64, device=dev),
                         ins_on, inner_slots, _timeout(runtime), what)
        if post_order:
            merged = _order_merged(plan, merged, cols.get(STR_RANK))
        return state, merged

    return sharded


def _order_merged(plan, merged: dict, strrank=None) -> dict:
    """One global order by, offset and limit over the merged rows of the
    key-sharded step (the order-by columns the selection does not project
    ride along under ``ORDER_COL`` names); the meta counts the rows
    kept."""
    from siddhi_tpu_torch.core.plan.selector_plan import ORDER_COL, STR_RANK

    meta = merged.pop("__meta__")
    side = {k[len(ORDER_COL):]: merged.pop(k) for k in list(merged)
            if k.startswith(ORDER_COL)}
    if strrank is not None:
        side[STR_RANK] = strrank
    merged = plan.apply_order_limit(merged, side)
    meta = meta.clone()
    meta[2] = merged[VALID_KEY].sum(dtype=torch.int64)
    merged["__meta__"] = meta
    return merged


def sharded_jit_for(runtime, fn, timer: bool = False):
    """A pattern's per-stream step (``fn(state, cols, now, rounds)``) or
    its TIMER sweep (``fn(state, now)``, ``timer``) over the runtime's
    key-sharded layout across processes: the step runs on this process's
    partition keys (the host already took its rows and made their keys
    local: ``NFAQueryRuntime.process_stream_batch``), and the matches of
    every process merge in the unsharded emission order, event row then
    slot for a stream step (the ``[B, S+1]`` row-major emission) and key
    then slot for the sweep (``[K, S]``); an order by / limit without a
    group by then runs once, on the merged rows."""
    from siddhi_tpu_torch.core.plan.selector_plan import STR_RANK

    layout = runtime._route_layout
    n, first = layout.n, layout.first
    S = runtime.stage.plan.slots
    dev = runtime.device
    ins_on = runtime._instruments_on()
    inner_slots = runtime._step_instrument_slots()
    plan = runtime.selector_plan
    # without a group by the selector ran unordered on each process
    # (NFAQueryRuntime._select): one ordering over the merged rows
    post_order = plan.ordered and runtime.keyer is None
    def sharded(state, *args, **kw):
        out = dict(_step_on_shard(layout, fn, state, 0, *args, **kw))
        meta = out.pop("__meta__")
        valid = out[VALID_KEY]
        pos = torch.arange(valid.shape[0], dtype=torch.int64, device=dev)
        if timer and PK_KEY in out:
            okey = (out[PK_KEY].to(torch.int64) * n + first) * S + pos % S
            rows = torch.zeros(1, dtype=torch.int64, device=dev)
        else:
            okey = pos
            rows = args[0][VALID_KEY].sum(dtype=torch.int64).reshape(1)
        okey = torch.where(valid, okey, torch.full_like(okey, _ROUTE_BIG))
        for k in (PK_KEY, GK_KEY):
            if k in out:
                out[k] = (out[k].to(torch.int64) * n + first).to(out[k].dtype)
        merged = _egress(layout, out, okey, meta[None], rows,
                         torch.zeros((), dtype=torch.int64, device=dev),
                         ins_on, inner_slots, _timeout(runtime),
                         f"query '{runtime.name}' sharded step")
        if post_order and merged[VALID_KEY].shape[0]:
            # (no process's emission had a row: nothing was selected)
            strrank = None
            if plan.needs_str_rank:
                strrank = (args[0][STR_RANK] if not timer else torch.as_tensor(
                    runtime.dictionary.rank_table(), device=dev))
            merged = _order_merged(plan, merged, strrank)
        return state, merged

    return sharded


def _record_route_telemetry(telemetry, scope: str, rows, exchange_ms) -> None:
    """``shard.rows.{scope}.{i}`` gauges (the rows of the last batch bound
    for each shard) and the ``shard.exchange_ms.{scope}`` histogram, on the
    app's registry with the query as the scope. Despite its name, that
    histogram holds the host's routing prep of a batch (padding, the quota
    pre-check, the split, the key tables), the time of the ``route.prep``
    span: not the exchange between shards, which runs on the card inside
    the step. A re-install onto a LARGER mesh grows the gauge set."""
    if exchange_ms is not None:
        telemetry.histogram(f"shard.exchange_ms.{scope}").record(exchange_ms)
    store = _ROUTE_ROWS.setdefault(telemetry, {})
    prev = store.get(scope)
    known = 0 if prev is None else prev.shape[0]
    store[scope] = np.asarray(rows, np.int64)
    for i in range(known, len(store[scope])):
        telemetry.gauge(
            f"shard.rows.{scope}.{i}",
            lambda s=scope, j=i, st=store: (
                float(st[s][j]) if j < st[s].shape[0] else 0.0))


# registry -> {scope: np[n] last routed rows}. Weak keys: a dead app's
# registry must not pin its arrays, and a NEW registry at a recycled
# address must not inherit the old one's "already registered" state
_ROUTE_ROWS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def prepare_routed_batches(runtime, cols):
    """Host side of the routed dispatch: pad the batch to a multiple of
    the shard count, pre-check the per-(source, destination) exchange
    quotas, and SPLIT oversized batches in half until every piece fits
    (every process makes the same pieces: its batch is everyone's). Also
    records the shard-skew gauges and the host prep's histogram. Returns
    the column dicts to dispatch in order. The key-sharded step with a
    replicated batch moves no rows: its batch goes whole."""
    with span("route.prep", query=runtime.name) as sp:
        pieces = _prepare_routed(runtime, cols)
        sp.set(pieces=len(pieces))
    return pieces


def _prepare_routed(runtime, cols):
    import time

    t0 = time.perf_counter()
    layout = runtime._route_layout
    n, quota = layout.n, layout.quota
    cols = {k: np.asarray(v) for k, v in dict(cols).items()}
    key_name = PK_KEY if layout.partitioned else GK_KEY

    def pad_to_mult(c):
        B = c[VALID_KEY].shape[0]
        if B % n == 0:
            return c
        pad = n - B % n
        return {k: np.concatenate(
            [v, np.zeros((pad,) + v.shape[1:], v.dtype)]) for k, v in c.items()}

    pieces = []

    def emit(c):
        c = pad_to_mult(c)
        B = c[VALID_KEY].shape[0]
        Bl = B // n
        valid = c[VALID_KEY].astype(bool)
        key = c[key_name].astype(np.int64)
        src = np.arange(B) // Bl
        pair = (src * n + key % n)[valid]
        counts = np.bincount(pair, minlength=n * n)
        if int(counts.max(initial=0)) <= quota or B <= n:
            pieces.append(c)
            return
        half = max((B // 2 // n) * n, n)
        emit({k: v[:half] for k, v in c.items()})
        emit({k: v[half:] for k, v in c.items()})

    if layout.split:
        pieces.append(cols)
    else:
        emit(cols)
    if layout.use_lut:
        # refreshed only when the host LUT changed (one copy), then handed
        # to every piece as input columns
        lut, inv = layout.device_luts()
        for piece in pieces:
            piece[LUT_KEY], piece[INV_KEY] = lut, inv
    dest_rows = np.bincount(
        (np.asarray(cols[key_name], np.int64) % n)[np.asarray(cols[VALID_KEY], bool)],
        minlength=n)
    _record_route_telemetry(runtime.app_context.telemetry, runtime.name, dest_rows,
                            (time.perf_counter() - t0) * 1000.0)
    return pieces


def ensure_routed_capacity(runtime) -> None:
    """Routed analog of ``QueryRuntime._ensure_capacity``: grow per-shard
    capacities when the GLOBAL key population outgrows ``n * localK`` /
    ``n * local_win`` (or key skew overfills one shard's group-key slice),
    re-laying the live state out via its canonical form."""
    layout = runtime._route_layout
    n = layout.n
    needed_sel = runtime._needed_sel_keys()
    needed_win = (runtime.partition_ctx.num_keys()
                  if runtime.partition_ctx is not None else 1)
    fits = layout.sync_gk(runtime.keyer)
    grow_sel = needed_sel > n * layout.localK or not fits
    grow_win = layout.partitioned and needed_win > n * layout.local_win
    if not (grow_sel or grow_win):
        return
    Kg = n * layout.localK
    while needed_sel > Kg:
        Kg *= 2
    Wg = n * layout.local_win if layout.partitioned else 1
    while layout.partitioned and needed_win > Wg:
        Wg *= 2
    overload = getattr(runtime.app_context, "overload", None)
    if overload is not None and runtime._state is not None:
        # the device-memory budget gate (resilience/overload.py): routed
        # growth lays the whole state out again at the grown global
        # capacity, so it is denied before the canonical copy, the new
        # state or the new step exist. The projection is the canonical
        # footprint (tensor metadata, no device read) times the growth
        from siddhi_tpu_torch.resilience.overload import ensure_memory_budget

        ratio = max(Kg / max(n * layout.localK, 1),
                    (Wg / max(n * layout.local_win, 1)
                     if layout.partitioned else 1.0))
        ensure_memory_budget(
            runtime.app_context, f"query.{runtime.name}",
            int(_canonical_nbytes(runtime) * ratio),
            what=f"query '{runtime.name}' routed key-capacity growth "
                 f"({n * layout.localK}->{Kg} global keys)")
    canonical = _canonical_tensors(runtime) if runtime._state is not None else None
    _install_routed(runtime, layout, canonical, Kg, Wg)
    if overload is not None:
        from siddhi_tpu_torch.core.util.statistics import pytree_nbytes
        from siddhi_tpu_torch.resilience.overload import charge_memory

        charge_memory(runtime.app_context, f"query.{runtime.name}",
                      pytree_nbytes(runtime._state))


def adopt_canonical(runtime, canonical, sel_keys_g: int, win_keys_g: int) -> None:
    """Snapshot-restore hook: lay the CANONICAL state of a revision (at
    its global capacities: unsharded, or routed at another shard or
    process count) out on this runtime's layout."""
    _install_routed(runtime, runtime._route_layout, canonical, sel_keys_g, win_keys_g)


def canonical_key_rows(runtime, arr) -> np.ndarray:
    """A host-kept per-key array of a runtime key-sharded across processes
    (one shard a process: row l is global key ``l * n + process``) -> the
    canonical array over every key (one ``all_gather``)."""
    from siddhi_tpu_torch.ops.exchange import all_gather_same

    t = torch.from_numpy(np.ascontiguousarray(arr)).to(runtime.device)
    parts = all_gather_same([t])[0]
    return torch.stack(parts, dim=1).reshape(-1).cpu().numpy()
