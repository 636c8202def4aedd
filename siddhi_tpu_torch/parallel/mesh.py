"""Device-side repartitioning of a keyed query over n logical shards.

Counterpart of the device-routed path of ``siddhi_tpu/parallel/mesh.py``
(``device_route_query_step`` and what it installs). The reference runs one
``shard_map`` over a mesh of n chips. This port holds the n shards' state
side by side on ONE card, in the reference's shard-major layout for its
global arrays (``_canonical_to_routed``): shard s owns key rows
``[s*localK, (s+1)*localK)`` of every keyed state tensor. One routed step:

ingress   the unrouted batch is cut into n source slices ``[n, B/n]``;
          ``owner = key % n`` per row, rows bucket per (source, owner)
          with a per-pair quota of ``rows_per_shard // n`` (over-quota rows
          are counted, not silently dropped), and one
          ``ring_exchange_cols`` call (one kernel launch) moves every
          column's buckets, the row index included, to their owners. Rows
          arrive source-major, i.e. in original batch order.
local     partition- and group-key columns become per-shard local ids
          (pk // n; the group key through a host-kept LUT) and each shard
          steps views of its own state slice, in place.
egress    emitted rows of all shards are concatenated and sorted once by
          their global emission-order key, which reproduces the unrouted
          output row for row. The meta is
          ``[overflow, notify, count, route_overflow, rows_0..rows_n-1]``.

Both values of ``siddhi_tpu.shard_exchange`` (``all_to_all``,
``pallas_ring``) take this one path on one card: one ``ring_exchange_cols``
call per dispatch, which launches the CUDA kernel once for all columns.
The exchange has one transport there; the knob stays parsed so configs
carry over. Peer copies over NVLink across cards are later work and will
keep the one-buffer ``ring_exchange(buf, n)`` signature. Unlike the reference, nothing swaps
the exchange for another off the accelerator: a CPU runtime uses the
kernel's plain version because its tensors lie on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from siddhi_tpu_torch.ops.exchange import ring_exchange_cols
from siddhi_tpu_torch.ops.expressions import (
    OKEY_KEY, PK_KEY, RIDX_KEY, VALID_KEY, CompileError)

GK_KEY = "__gk__"
# the group-key LUT pair of a routed step with a distinct group key
# (``RouteLayout.device_luts``), staged before the step as input columns:
# a captured step reads its static copies, and the LUT is each app's own
LUT_KEY = "__route_lut__"
INV_KEY = "__route_inv__"
_ROUTE_BIG = 2 ** 62


@dataclass(frozen=True)
class Mesh:
    """n logical shards on one device (``None``: the runtime's device)."""

    n: int
    device: Optional[torch.device] = None


def make_mesh(n_devices: int, device=None) -> Mesh:
    """A mesh of ``n_devices`` logical shards co-resident on ``device``."""
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
    arrays (``"sel"``, shape ``[slots, K]``) by the axis sized
    ``num_keys``; partitioned window buffers (``"win"``, key-contiguous
    flat rings ``[Kw*W]`` or per-key ``[Kw]``) along axis 0."""
    if leaf.dim() == 0:
        return -1
    top = path[0] if path else None
    if top == "sel":
        for i, s in enumerate(leaf.shape):
            if s == num_keys:
                return i
    if top == "win" and win_keys > 1 and leaf.shape[0] % win_keys == 0:
        return 0
    return -1


def _leaf_space(path) -> str:
    return "gk" if path and path[0] == "sel" else "pk"


def _buffered_id_col(path) -> Optional[str]:
    """'gk'/'pk' when this window-buffer leaf stores key ids whose VALUES
    must translate between local and global id spaces."""
    if path and path[0] == "win" and path[-1] in (GK_KEY, PK_KEY):
        return "gk" if path[-1] == GK_KEY else "pk"
    return None


class RouteLayout:
    """Host-side bookkeeping of one routed query: shard count, receive
    capacity, and the group-key local-id LUT that carries a distinct GK
    through the exchange. ``localK``/``local_win`` mirror the runtime's
    per-shard capacity fields; ``n * localK`` is the global dense-id
    capacity the keyer allocates into."""

    def __init__(self, mesh: Mesh, rows_per_shard: int, exchange: str,
                 partitioned: bool, use_lut: bool, device):
        self.mesh = mesh
        self.n = mesh.n
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
        self._lut_dev = (torch.from_numpy(lut).to(self.device),
                         torch.from_numpy(inv).to(self.device))
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
    """Why this runtime cannot take the routed path (None = it can): the
    ported scope is partitioned queries over keyed length windows (or no
    window), and non-partitioned grouped queries without a window."""
    from siddhi_tpu_torch.core.query.join_runtime import JoinQueryRuntime
    from siddhi_tpu_torch.core.query.nfa_runtime import NFAQueryRuntime
    from siddhi_tpu_torch.ops.keyed_windows import KeyedLengthWindowStage

    if isinstance(runtime, NFAQueryRuntime):
        return ("pattern and sequence queries (an NFA step over a mesh is "
                "not ported yet)")
    if isinstance(runtime, JoinQueryRuntime):
        return ("join queries (routed joins over a mesh are not ported yet: "
                "ROADMAP A.9)")
    sp = runtime.selector_plan
    if sp.order_by or sp.limit is not None or sp.offset is not None:
        return "order by / limit (batch-global ordering)"
    distinct = [s.kind for s in sp.specs if s.kind in ("distinctcount", "unionset")]
    if distinct:
        return (f"{'/'.join(sorted(set(distinct)))} (routing [K, H] value "
                f"tables over shards is not ported yet)")
    win = runtime.window_stage
    if win is not None and not isinstance(win, KeyedLengthWindowStage):
        return (f"window stage {type(win).__name__} (emission-order keys "
                f"not global-aware yet)")
    if win is not None and runtime.partition_ctx is None:
        return "global (non-partitioned) windows"
    if runtime.partition_ctx is None and runtime.keyer is None:
        return "unkeyed queries (nothing to route by)"
    return None


def _release_from_fanout(runtime):
    """A routed step owns the runtime's dispatch: a fused fan-out group
    (core/query/fused_fanout.py) would keep stepping the member through its
    unrouted fused step, so hand the member back its own junction
    subscription before installing the routed one."""
    group = getattr(runtime, "_fanout_group", None)
    if group is not None:
        group.release(runtime)


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
    ``runtime._step`` so junction-fed batches take the routed path."""
    why = route_ineligibility(runtime)
    if why is not None:
        raise CompileError(
            f"query '{runtime.name}': device routing does not support {why}")
    if mesh.device is not None and mesh.device != runtime.device:
        raise ValueError(
            f"mesh device {mesh.device} differs from the runtime's "
            f"{runtime.device}")
    if exchange is None:
        exchange = getattr(runtime.app_context, "shard_exchange", "all_to_all")
    if exchange not in ("all_to_all", "pallas_ring"):
        raise ValueError(f"unknown shard exchange {exchange!r}")
    _release_from_fanout(runtime)
    partitioned = runtime.partition_ctx is not None
    use_lut = partitioned and runtime.keyer is not None

    if runtime._route_layout is not None:
        canonical = _canonical_tensors(runtime)
        old = runtime._route_layout
        Kg = old.n * old.localK
        Wg = old.n * old.local_win if old.local_win > 1 else runtime._win_keys
    else:
        Kg = runtime.selector_plan.num_keys
        Wg = runtime._win_keys
        canonical = runtime._state

    layout = RouteLayout(mesh, rows_per_shard, exchange, partitioned, use_lut,
                         runtime.device)
    _install_routed(runtime, layout, canonical, Kg, Wg)
    return runtime._step, runtime._state


def _install_routed(runtime, layout: RouteLayout, canonical, Kg: int, Wg: int):
    """Size the per-shard capacities, (re)build the GK LUT, lay the
    canonical state out shard-major, and build the routed step."""
    n = layout.n
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
    runtime.selector_plan.num_keys = layout.localK
    runtime._win_keys = layout.local_win
    runtime._route_layout = layout
    runtime._state = None      # release the old layout before allocating
    runtime._state = _canonical_to_routed(runtime, layout, canonical)
    runtime._step = routed_step_for(runtime)


def _pow2_div(total: int, n: int) -> int:
    """total/n rounded up to the next power of two."""
    k = 1
    need = (total + n - 1) // n
    while k < need:
        k *= 2
    return k


def _global_axes(layout: RouteLayout, path, leaf) -> int:
    n, Kl, Wl = layout.n, layout.localK, layout.local_win
    return _key_axis_of(path, leaf, n * Kl, n * Wl if Wl > 1 else 1)


# -------------------------------------------------------- state relayout

def _canonical_tensors(runtime):
    """Routed (shard-major) state -> canonical unsharded layout, as
    tensors on the runtime's device."""
    layout = runtime._route_layout
    n, Kl = layout.n, layout.localK
    dev = runtime.device
    pos_gk = torch.from_numpy(layout.gk_positions()).to(dev)
    inv_gk_vals = (torch.from_numpy(layout.gk_inverse_values()).to(dev)
                   if layout.use_lut else None)

    def one(path, leaf):
        ax = _global_axes(layout, path, leaf)
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
        return leaf.view(keys, -1)[pos].reshape(-1)

    return _map_tree(one, runtime._state)


def canonical_route_state(runtime):
    """Routed state -> canonical unsharded layout, host-side numpy (the
    form the reference's snapshots and ``jax.device_get`` produce)."""
    return _map_tree(lambda _p, t: t.cpu().numpy(), _canonical_tensors(runtime))


def _canonical_to_routed(runtime, layout: RouteLayout, canonical):
    """Canonical state (numpy or tensors, possibly smaller capacity) ->
    routed shard-major layout at the layout's capacities; missing key rows
    come from init."""
    n, Kl, Wl = layout.n, layout.localK, layout.local_win
    dev = runtime.device
    local_init = runtime._init_state()

    def stack(path, leaf):
        ax = _key_axis_of(path, leaf, Kl, Wl if Wl > 1 else 1)
        if ax < 0:
            return torch.stack([leaf] * n, dim=0)
        return torch.cat([leaf] * n, dim=ax)

    routed = _map_tree(stack, local_init)
    del local_init
    if canonical is None:
        return routed
    pos_gk_np = layout.gk_positions()
    if layout.use_lut:
        layout._resize_gk(n * Kl)

    def one(path, out, canon):
        canon = torch.as_tensor(np.asarray(canon) if not isinstance(
            canon, torch.Tensor) else canon).to(dev)
        ax = _global_axes(layout, path, out)
        if ax < 0:
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
        keys = n * Wl
        W = out.shape[0] // keys
        ng = min(canon.shape[0] // max(W, 1), keys)
        pos = torch.from_numpy(layout.pk_positions(Wl)[:ng]).to(dev)
        out.view(keys, W)[pos] = canon[: ng * W].view(ng, W).to(out.dtype)
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
    """Views of shard ``s``'s slice of every routed state tensor."""
    n = layout.n

    def view(path, leaf):
        ax = _global_axes(layout, path, leaf)
        if ax < 0:
            return leaf[s]
        size = leaf.shape[ax] // n
        return leaf.narrow(ax, s * size, size)

    return _map_tree(view, state)


def routed_step_for(runtime):
    """Build the routed ``step3(state, cols, now)`` for a runtime whose
    ``_route_layout`` is installed, through the step instrument under
    family ``device_routed`` with the layout as its extra witness: on the
    card a capturable routed step (a keyed length window or none, and the
    exchange kernel) replays as one CUDA graph a dispatch, and equal
    routed programs of two apps share one program-cache entry."""
    import time

    t0 = time.perf_counter()
    layout = runtime._route_layout
    fn = _routed_fn(runtime, layout)
    extra = (f"n={layout.n} quota={layout.quota} localK={layout.localK} "
             f"local_win={layout.local_win} partitioned={layout.partitioned} "
             f"use_lut={layout.use_lut}")
    return runtime.instrument_step(
        fn, f"query.{runtime.name}.step", family="device_routed",
        cache_extra=extra, build_ms=(time.perf_counter() - t0) * 1000.0)


def _routed_fn(runtime, layout: "RouteLayout"):
    n, Q = layout.n, layout.quota
    localK = layout.localK
    partitioned, use_lut = layout.partitioned, layout.use_lut
    step = runtime.build_step_fn()
    key_name = PK_KEY if partitioned else GK_KEY
    dev = runtime.device

    if n == 1:
        def one_dev(state, cols, now):
            cols = dict(cols)
            cols.pop(LUT_KEY, None)     # one shard: local ids are global
            cols.pop(INV_KEY, None)
            B = cols[VALID_KEY].shape[0]
            cols[RIDX_KEY] = torch.arange(B, dtype=torch.int64, device=dev)
            rows = cols[VALID_KEY].sum(dtype=torch.int64)
            _st, out = step(_shard_views(layout, state, 0), cols, now)
            out = dict(out)
            meta = out.pop("__meta__")
            out.pop(OKEY_KEY, None)   # single shard: already in order
            out["__meta__"] = torch.cat(
                [meta[:3], torch.zeros(1, dtype=torch.int64, device=dev), rows[None]])
            return state, out

        return one_dev

    def step3(state, cols, now):
        cols = dict(cols)
        lut, inv = cols.pop(LUT_KEY, None), cols.pop(INV_KEY, None)
        if use_lut and lut is None:     # a direct caller: the layout's own
            lut, inv = layout.device_luts()
        B = cols[VALID_KEY].shape[0]
        Bl = B // n
        valid = cols[VALID_KEY].view(n, Bl)
        ridx = torch.arange(B, dtype=torch.int64, device=dev)
        # owner shard per row (invalid rows route nowhere: owner = n)
        owner = torch.where(valid, cols[key_name].view(n, Bl).to(torch.int64) % n,
                            torch.full((n, Bl), n, dtype=torch.int64, device=dev))
        dest = torch.arange(n, dtype=torch.int64, device=dev)[None, :, None]
        maskd = owner[:, None, :] == dest                         # [src, dst, Bl]
        pos = torch.cumsum(maskd.to(torch.int64), dim=2) - 1
        owner_c = torch.clamp(owner, 0, n - 1)
        pos_row = torch.gather(pos, 1, owner_c[:, None, :]).squeeze(1)  # [n, Bl]
        sendable = owner < n
        sent_row = sendable & (pos_row < Q)
        route_ov = (sendable & ~sent_row).sum(dtype=torch.int64)
        src = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
        # one flat send buffer per column: source s's segment d starts at
        # s*n*Q + d*Q; unsent rows land in one trailing dump slot
        slot = torch.where(sent_row, src * (n * Q) + owner * Q + pos_row,
                           torch.full_like(pos_row, n * n * Q)).reshape(-1)

        def pack(col):
            tail = tuple(col.shape[1:])
            buf = torch.zeros((n * n * Q + 1,) + tail, dtype=col.dtype, device=dev)
            buf[slot] = col
            return buf[: n * n * Q].view((n, n * Q) + tail)

        # every column and the row index in ONE exchange call
        sent = [pack(v) for v in cols.values()] + [pack(ridx)]
        rcols = dict(zip([*cols, RIDX_KEY], ring_exchange_cols(sent, n)))
        rows_here = rcols[VALID_KEY].sum(dim=1, dtype=torch.int64)   # [n]
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
        for s in range(n):
            _st, out = step(_shard_views(layout, state, s),
                            {k: v[s] for k, v in rcols.items()}, now)
            out = dict(out)
            metas.append(out.pop("__meta__"))
            okey = out.pop(OKEY_KEY).to(torch.int64)
            okeys.append(torch.where(out[VALID_KEY], okey,
                                     torch.full_like(okey, _ROUTE_BIG)))
            # local -> global ids on the emitted rows
            if partitioned and PK_KEY in out:
                pko = out[PK_KEY]
                out[PK_KEY] = (pko.to(torch.int64) * n + s).to(pko.dtype)
            if GK_KEY in out:
                gko = out[GK_KEY]
                if use_lut:
                    gg = inv[s, torch.clamp(gko.to(torch.int64), 0, localK - 1)]
                else:
                    gg = gko.to(torch.int64) * n + s
                out[GK_KEY] = gg.to(gko.dtype)
            outs.append(out)
        # ordered re-merge: sort every shard's emitted rows once by the
        # global emission-order key (invalid rows sort last)
        order = torch.argsort(torch.cat(okeys), stable=True)
        merged = {k: torch.cat([o[k] for o in outs])[order] for k in outs[0]}
        meta = torch.stack(metas)                                 # [n, 3]
        ov = meta[:, 0].sum()
        ntb = torch.where(meta[:, 1] < 0, torch.full_like(meta[:, 1], _ROUTE_BIG),
                          meta[:, 1]).min()
        nt = torch.where(ntb >= _ROUTE_BIG, torch.full_like(ntb, -1), ntb)
        cnt = meta[:, 2].sum()
        merged["__meta__"] = torch.cat([torch.stack([ov, nt, cnt, route_ov]),
                                        rows_here])
        return state, merged

    return step3


def prepare_routed_batches(runtime, cols):
    """Host side of the routed dispatch: pad the batch to a multiple of
    the shard count, pre-check the per-(source, destination) exchange
    quotas, and SPLIT oversized batches in half until every piece fits.
    Returns the column dicts to dispatch in order."""
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

    emit(cols)
    if layout.use_lut:
        # refreshed only when the host LUT changed (one copy), then handed
        # to every piece as input columns
        lut, inv = layout.device_luts()
        for piece in pieces:
            piece[LUT_KEY], piece[INV_KEY] = lut, inv
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
    canonical = _canonical_tensors(runtime) if runtime._state is not None else None
    Kg = n * layout.localK
    while needed_sel > Kg:
        Kg *= 2
    Wg = n * layout.local_win if layout.partitioned else 1
    while layout.partitioned and needed_win > Wg:
        Wg *= 2
    _install_routed(runtime, layout, canonical, Kg, Wg)
