"""The partitioned join engine (K6): PanJoin on the device.

Counterpart of ``siddhi_tpu/core/join/engine.py``. The broadcast probe
(``core/query/join_runtime.py``) compares the N trigger rows of a step
with the other side's whole W-slot ring. For eligible stream-stream
window joins this engine indexes each side's ring by a hash-partitioned
``[P, Wp]`` sub-window directory (PanJoin, "A Partition-based Adaptive
Stream Join", PAPERS.md), and a trigger row gathers only its own hash
partition of the other side: the condition evaluates on ``[N, Wp]``
instead of ``[N, W]``. One step per arriving chunk inserts into its own
side's ring and directory and probes the other side's directory, and
stamps a cross-stream sequence number into the meta, so the pump's drain
can check that left and right batches come back in dispatch order.

The engine's rows equal the broadcast probe's, row for row:

- a directory entry is a member's global arrival sequence ``gseq``; its
  ring slot is ``gseq % W`` and it is live when ``gseq >= floor``
  (length windows: ``total - W``; time windows: ``expired_upto``), so the
  directory holds exactly the rows ``WindowStage.contents`` reports live;
- the matched rows re-sort by ``trigger_row * (W + 1) + ring_slot``
  (one-sided rows at slot W), the broadcast probe's row-major order.

Partitioning engages only when the ``on`` condition has an equality
conjunct over hashable types (int/long/bool/string; a float key keeps
the broadcast compare, as ``-0.0 == 0.0`` and NaN would break equal
values => equal hash); without one the engine runs the same step with
the broadcast probe (P = 1).

The host mirrors each side's ring occupancy per partition (slot = seq %
W is ring mechanics, so the mirror is exact with no device read) and
grows a side's ``Wp`` before a batch could overflow it; ``shrink_
partitions`` releases what growth added once a skew burst has passed.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from siddhi_tpu_torch.core.event import CURRENT, LazyColumns
from siddhi_tpu_torch.core.plan.selector_plan import STR_RANK
from siddhi_tpu_torch.core.table.in_memory_table import host
from siddhi_tpu_torch.ops.expressions import NUMPY_XP, TYPE_KEY, VALID_KEY, TorchXP
from siddhi_tpu_torch.ops.scatter import put_where_
from siddhi_tpu_torch.ops.windows import (
    LengthWindowStage, PassthroughWindowStage, TimeWindowStage, conform_cols)
from siddhi_tpu_torch.query_api.definitions import AttrType

_LOG = logging.getLogger("siddhi_tpu_torch.join.engine")

_BIG = 2 ** 62

# the engine's own state keys: the per-side partition directories and the
# cross-stream sequence (derived state, rebuilt by rebuild_probe_state)
PIDX_KEYS = ("lpidx", "rpidx")
SEQ_KEY = "jseq"
ENGINE_STATE_KEYS = PIDX_KEYS + (SEQ_KEY,)

_HASHABLE = (AttrType.INT, AttrType.LONG, AttrType.BOOL, AttrType.STRING)


# ------------------------------------------------------------ eligibility

def engine_ineligibility(rt) -> Optional[str]:
    """Why this join runtime cannot run the engine (None = it can, else a
    ``core.eligibility.Reason``): unpartitioned stream-stream joins whose
    sides are length, time or externalTime windows or windowless. Store
    sides (tables, named windows), host windows and `partition with` joins
    (a keyed [K, W] ring is partition-local already) keep the broadcast
    probe."""
    from siddhi_tpu_torch.core.eligibility import ReasonCode as RC
    from siddhi_tpu_torch.core.eligibility import reason

    if rt.partition_ctx is not None:
        return reason(RC.PARTITIONED,
                      "partitioned join (keyed rings are already partition-local)")
    if rt.index_probe is not None:
        return reason(RC.INDEXED_PROBE, "indexed table probe")
    for side in rt.sides.values():
        if side.store is not None:
            return reason(RC.STORE_SIDE, f"shared-store side '{side.stream_id}'")
        if side.host_window is not None:
            return reason(RC.HOST_WINDOW, f"host-mode window side '{side.stream_id}'")
        if not isinstance(side.window_stage, (LengthWindowStage, TimeWindowStage,
                                              PassthroughWindowStage)):
            return reason(RC.WINDOW_KIND,
                          f"window stage {type(side.window_stage).__name__} on side "
                          f"'{side.stream_id}' (no partition adapter yet)")
    return None


def pipeline_ineligibility(rt) -> Optional[str]:
    """Why this join runtime's batches may not ride the CompletionPump
    (None = they may, else a ``core.eligibility.Reason``): any join whose
    probe surfaces live in its own state, without a host group keyer or an
    indexed table probe."""
    from siddhi_tpu_torch.core.eligibility import ReasonCode as RC
    from siddhi_tpu_torch.core.eligibility import reason

    for side in rt.sides.values():
        if side.store is not None:
            return reason(RC.STORE_SIDE,
                          f"shared-store probe side '{side.stream_id}' "
                          f"(host-interleaved contents)")
        if side.host_window is not None:
            return reason(RC.HOST_WINDOW, f"host-mode window side '{side.stream_id}'")
        if side.window_stage is None:
            return reason(RC.NO_WINDOW, f"side '{side.stream_id}' has no window stage")
    if rt.keyer is not None:
        return reason(RC.GROUPED_SELECT,
                      "grouped selector (host keyed select between stages)")
    if rt.index_probe is not None:
        return reason(RC.INDEXED_PROBE, "indexed table probe")
    return None


# ---------------------------------------------------- equality extraction

def extract_partition_keys(on_expr, left, right, dictionary):
    """An equality conjunct ``<left-side expr> == <right-side expr>`` of
    the ``on`` condition (the whole condition, or one conjunct of a top-
    level And) over hashable types, each side's value compiled against
    that side's own (unprefixed) columns: ``{"left": fn, "right": fn}``,
    or None."""
    from siddhi_tpu_torch.core.plan.resolvers import SingleStreamResolver
    from siddhi_tpu_torch.ops.expressions import compile_expr
    from siddhi_tpu_torch.ops.types import is_numeric, promote
    from siddhi_tpu_torch.query_api.expressions import (
        And, AttributeFunction, Compare, Variable)

    def vars_of(e, out):
        if isinstance(e, Variable):
            out.append(e)
        for name in ("left", "right", "expression"):
            c = getattr(e, name, None)
            if c is not None and not isinstance(c, (str, int, float, bool)):
                vars_of(c, out)
        if isinstance(e, AttributeFunction):
            for p in e.parameters:
                vars_of(p, out)
        return out

    def side_ids(s):
        return {s.stream_id, s.ref_id} - {None}

    def owner_of(expr):
        """The side an expression reads (None: mixed or unqualified)."""
        vs = vars_of(expr, [])
        if not vs or any(v.stream_id is None for v in vs):
            return None
        owners = set()
        for v in vs:
            in_l = v.stream_id in side_ids(left)
            in_r = v.stream_id in side_ids(right)
            if in_l == in_r:      # ambiguous (a self-join's raw id) or neither
                return None
            owners.add("left" if in_l else "right")
        return owners.pop() if len(owners) == 1 else None

    def try_eq(e):
        if not isinstance(e, Compare) or e.operator != "==":
            return None
        oa, ob = owner_of(e.left), owner_of(e.right)
        if oa is None or ob is None or oa == ob:
            return None
        by_side = {oa: e.left, ob: e.right}
        fns, types = {}, {}
        for key, side in (("left", left), ("right", right)):
            res = SingleStreamResolver(side.definition, dictionary,
                                       ref_id=side.ref_id)
            try:
                fns[key], types[key] = compile_expr(by_side[key], res)
            except Exception:  # noqa: BLE001 — keep the broadcast probe
                return None
        if any(t not in _HASHABLE for t in types.values()):
            return None
        if types["left"] != types["right"]:
            # mixed types keep equal values => equal hashes only for
            # numeric pairs with a lossless promotion
            if not (is_numeric(types["left"]) and is_numeric(types["right"])):
                return None
            try:
                promote(types["left"], types["right"])
            except Exception:  # noqa: BLE001 — incomparable types
                return None
        return fns

    hit = try_eq(on_expr)
    if hit is not None:
        return hit
    if isinstance(on_expr, And):
        for part in (on_expr.left, on_expr.right):
            hit = try_eq(part)
            if hit is not None:
                return hit
    return None


# ------------------------------------------------------------ hashing

_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _signed(u: int) -> int:
    return u - (1 << 64) if u >= (1 << 63) else u


def _srl(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (as on uint64)."""
    return (h >> k) & ((1 << (64 - k)) - 1)


def hash_partition_dev(vals, P: int) -> torch.Tensor:
    """The splitmix64 finalizer -> partition id in [0, P) (P a power of
    two), on int64 bit patterns: a multiply wraps modulo 2^64 as uint64's
    does, and the shifts are logical, so the ids equal the reference's
    uint64 ``hash_partition_dev`` for every int32/int64/bool/string-id
    key."""
    h = torch.as_tensor(vals).to(torch.int64)
    h = (h ^ _srl(h, 30)) * _signed(_MIX1)
    h = (h ^ _srl(h, 27)) * _signed(_MIX2)
    h = h ^ _srl(h, 31)
    return (h & (P - 1)).to(torch.int32)


def hash_partition_np(vals, P: int) -> np.ndarray:
    """The host mirror of ``hash_partition_dev`` (uint64 numpy): the
    occupancy mirror and the directory rebuild partition with it."""
    h = np.asarray(vals).astype(np.int64).astype(np.uint64)
    with np.errstate(over="ignore"):
        h = (h ^ (h >> np.uint64(30))) * np.uint64(_MIX1)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(_MIX2)
    h = h ^ (h >> np.uint64(31))
    return (h & np.uint64(P - 1)).astype(np.int32)


def _pow2(n: int, start: int = 1) -> int:
    k = max(start, 1)
    while k < n:
        k *= 2
    return k


# ------------------------------------------------------------ side plans

class _Candidates(dict):
    """A probe's eval dict whose other-side columns (``prefix``) are the
    ring columns ``buf`` gathered at the ``[N, Wp]`` candidate slots, each
    on its first read: a condition reads its key columns, not every
    attribute."""

    def __init__(self, base: dict, prefix: str, buf: dict, slots: torch.Tensor):
        super().__init__(base)
        self._prefix, self._buf, self._slots = prefix, buf, slots

    def _load(self, k):
        if (not dict.__contains__(self, k) and k.startswith(self._prefix)
                and k[len(self._prefix):] in self._buf):
            dict.__setitem__(self, k, self._buf[k[len(self._prefix):]][self._slots])

    def __getitem__(self, k):
        self._load(k)
        return dict.__getitem__(self, k)

    def get(self, k, default=None):
        self._load(k)
        return dict.get(self, k, default)

    def __contains__(self, k):
        self._load(k)
        return dict.__contains__(self, k)


class _SidePlan:
    """One side's partition-directory parameters (``use_pidx`` False: the
    side keeps the broadcast probe surface)."""

    __slots__ = ("kind", "W", "use_pidx", "Wp", "key_fn", "pidx_key",
                 "win_key")

    def __init__(self, side_key: str, side, pspec, P: int, slack: int):
        stage = side.window_stage
        if isinstance(stage, LengthWindowStage):
            self.kind, self.W = "length", int(stage.length)
        elif isinstance(stage, TimeWindowStage):
            self.kind, self.W = "time", int(stage.capacity)
        else:
            self.kind, self.W = "none", 1
        self.win_key = "lwin" if side_key == "left" else "rwin"
        self.pidx_key = "lpidx" if side_key == "left" else "rpidx"
        self.key_fn = pspec[side_key] if pspec is not None else None
        # partitioning pays only where the ring well exceeds the partition
        # count, and engages only where the host can mirror the ring's
        # partition occupancy exactly: every valid CURRENT row inserts at
        # slot seq % W, so in-step filters and transforms (which drop or
        # rewrite rows on the device) keep the full-surface probe
        self.use_pidx = (self.kind != "none" and self.key_fn is not None
                         and P > 1 and self.W >= 4 * P
                         and not side.filters and not side.transforms)
        self.Wp = _pow2((self.W * slack + P - 1) // P) if self.use_pidx else 0

    def live_floor(self, win_state) -> torch.Tensor:
        """Members with gseq >= floor are the rows contents() holds live."""
        if self.kind == "length":
            return torch.clamp(win_state["total"] - self.W, min=0)
        return torch.clamp(win_state["expired_upto"], min=0)

    def live_floor_np(self, win_state) -> int:
        if self.kind == "length":
            return max(int(win_state["total"]) - self.W, 0)
        return max(int(win_state["expired_upto"]), 0)


class DeviceJoinEngine:
    """The per-side partition plans and the fused insert + probe step of
    each side (``JoinQueryRuntime.build_side_step_fn`` hands over to it)."""

    def __init__(self, runtime, pspec):
        self.rt = runtime
        ac = runtime.app_context
        cfg_p = int(getattr(ac, "join_partitions", 0) or 0)
        if cfg_p <= 0:
            # auto, as the reference chooses: 8 on the card, 1 on the CPU
            # (the full-surface probe keeps the fused step). Measured on an
            # H100 (PERF.md, chip_smoke.py phase 20), P = 8 is slower than
            # the broadcast probe on bench_join's shape and on config #5's
            # 65,536-row Stock sends (a 100-row ring split 8 ways, plus the
            # host mirror), and faster only where few rows probe a wide
            # ring (config #5's Twitter sends)
            cfg_p = 1 if runtime.device.type == "cpu" else 8
        self.P = max(1, min(_pow2(cfg_p), 64))
        self.slack = max(1, int(getattr(ac, "join_partition_slack", 2)))
        # adaptive growth: when a batch would push one partition's ring
        # occupancy past Wp, grow Wp before the step (to at most pow2(W),
        # where no skew can overflow); off, an overflow raises naming
        # siddhi_tpu.join_partition_slack
        self.grow = bool(getattr(ac, "join_partition_grow", True))
        self._mirror: Dict[str, dict] = {}
        self.plans: Dict[str, _SidePlan] = {
            k: _SidePlan(k, runtime.sides[k], pspec, self.P, self.slack)
            for k in ("left", "right")}

    @property
    def partitioned_probe(self) -> bool:
        return any(p.use_pidx for p in self.plans.values())

    # ------------------------------------------------------------- state

    def init_pidx_state(self) -> dict:
        """The engine's state keys, merged into the runtime's state: empty
        directories and the cross-stream sequence."""
        dev = self.rt.device
        st = {SEQ_KEY: torch.zeros((), dtype=torch.int64, device=dev)}
        for plan in self.plans.values():
            if plan.use_pidx:
                st[plan.pidx_key] = {
                    "gseq": torch.full((self.P, plan.Wp), -1, dtype=torch.int64,
                                       device=dev),
                    "cnt": torch.zeros((self.P,), dtype=torch.int64, device=dev)}
        return st

    def partition_occupancy(self, side_key: str) -> np.ndarray:
        """Live members per partition of one side ([P] int64), with no
        device read: the last drained ``fill.<side>`` instrument lanes
        (the step computes them from the directory it holds and ships them
        on the meta pull it makes anyway); with instruments off, the host
        mirror of the ring's slots, exact for a length ring and an upper
        bound for a time ring (expired rows hold their slots until
        overwritten)."""
        plan = self.plans[side_key]
        if not plan.use_pidx:
            return np.zeros(self.P, np.int64)
        last = self.rt._instr_last.get(f"fill.{side_key}")
        if last is not None and np.asarray(last).shape[0] == self.P:
            return np.asarray(last, np.int64)
        mir = self._mirror.get(side_key)
        if mir is None:
            return np.zeros(self.P, np.int64)
        ring = mir["ring"]
        return np.bincount(ring[ring >= 0], minlength=self.P).astype(np.int64)[: self.P]

    # ------------------------------------------------------ restore path

    def rebuild_probe_state(self) -> None:
        """Derive the directories (and host mirrors) from the rings: after
        state is installed from outside, and after adaptive growth. Live
        rows re-insert in gseq order; partition offsets may differ from an
        uninterrupted run's, probe results cannot (membership and gseq are
        the same)."""
        if self.rt._state is None:
            return
        for side_key in self.plans:
            self._rebuild_side(side_key)
        if SEQ_KEY not in self.rt._state:
            self.rt._state[SEQ_KEY] = torch.zeros((), dtype=torch.int64,
                                                  device=self.rt.device)

    def _ring_partitions(self, plan, win) -> np.ndarray:
        """Partition id of every occupied ring slot of one side ([W] int32,
        -1 = empty), hashed from the ring's own values on the host."""
        total = int(win["total"])
        filled = min(total, plan.W)
        ring_p = np.full(plan.W, -1, np.int32)
        if filled:
            buf = {k: host(v) for k, v in win["buf"].items()}
            vals, mask = plan.key_fn(buf, {"xp": NUMPY_XP})
            vals = np.broadcast_to(np.asarray(vals), (plan.W,))
            pr = hash_partition_np(vals, self.P)
            if mask is not None:
                pr = np.where(np.broadcast_to(np.asarray(mask, bool), (plan.W,)),
                              np.int32(0), pr)
            ring_p[:filled] = pr[:filled]
        return ring_p

    def _rebuild_side(self, side_key: str) -> None:
        """Rebuild one side's directory and host mirror from its ring,
        growing Wp (to at most pow2(W)) when the ring is hotter than the
        sub-windows and growth is on; otherwise an unrepresentable ring
        raises naming the slack knob."""
        from siddhi_tpu_torch.core.stream.junction import FatalQueryError

        plan = self.plans[side_key]
        if not plan.use_pidx or self.rt._state is None:
            return
        state = self.rt._state
        win = state[plan.win_key]
        total = int(win["total"])
        ring_p = self._ring_partitions(plan, win)
        occ = np.bincount(ring_p[ring_p >= 0], minlength=self.P)
        need = int(occ.max(initial=0))
        if need > plan.Wp and self.grow:
            plan.Wp = min(_pow2(2 * need), _pow2(plan.W))
        floor = plan.live_floor_np({k: int(win[k]) for k in ("total", "expired_upto")
                                    if k in win})
        gseqs = np.arange(floor, total, dtype=np.int64)
        part = ring_p[gseqs % plan.W].astype(np.int64)
        cnt = np.bincount(part, minlength=self.P).astype(np.int64)
        if int(cnt.max(initial=0)) > plan.Wp:
            raise FatalQueryError(
                f"query '{self.rt.name}': {self.rt.overflow_knob_msg(code=4)}")
        # each partition's members in gseq order from its slot 0
        order = np.argsort(part, kind="stable")
        ps = part[order]
        rank = np.arange(ps.size) - (np.cumsum(cnt) - cnt)[ps]
        grid = np.full((self.P, plan.Wp), -1, np.int64)
        grid[ps, rank] = gseqs[order]
        dev = self.rt.device
        state[plan.pidx_key] = {"gseq": torch.from_numpy(grid).to(dev),
                                "cnt": torch.from_numpy(cnt).to(dev)}
        self._mirror[side_key] = {"ring": ring_p, "total": total}

    # ------------------------------------------------- adaptive capacity

    def prepare_batch(self, side_key: str, cols) -> bool:
        """Host bookkeeping ahead of one side's step: advance the side's
        ring-occupancy mirror with the batch's hashed keys, and grow the
        sub-windows before the step could overflow them. A partition's
        live members are a subset of its ring slots, so ``Wp >= max ring
        occupancy`` makes a directory overflow impossible. Returns True
        when a capacity changed (the built steps were dropped)."""
        plan = self.plans[side_key]
        if not plan.use_pidx:
            return False
        lazy = LazyColumns(cols)
        valid = host(lazy[VALID_KEY]).astype(bool) & (host(lazy[TYPE_KEY]) == CURRENT)
        n = int(valid.sum())
        if n == 0:
            return False
        B = valid.shape[0]
        hvals, hmask = plan.key_fn(lazy, {"xp": NUMPY_XP})
        p = hash_partition_np(np.broadcast_to(np.asarray(hvals), (B,)), self.P)
        if hmask is not None:
            p = np.where(np.broadcast_to(np.asarray(hmask, bool), (B,)), np.int32(0), p)
        p = p[valid]
        mir = self._mirror.get(side_key)
        if mir is None:
            mir = self._mirror[side_key] = {
                "ring": np.full(plan.W, -1, np.int32), "total": 0}
        W, ring = plan.W, mir["ring"]
        if n >= W:
            ring[:] = -1
            ring[(mir["total"] + np.arange(n - W, n)) % W] = p[n - W:]
        else:
            ring[(mir["total"] + np.arange(n)) % W] = p
        mir["total"] += n
        need = int(np.bincount(ring[ring >= 0], minlength=self.P).max(initial=0))
        if need <= plan.Wp or not self.grow:
            # growth off: the in-step check raises naming the slack knob
            return False
        plan.Wp = min(_pow2(2 * need), _pow2(plan.W))
        _LOG.info("query '%s': join partition sub-windows of side %s grown to "
                  "%d (ring occupancy %d)", self.rt.name, side_key, plan.Wp, need)
        # rebuild from the ring before this batch (the step inserts it into
        # the grown directory), then keep the batch-advanced mirror
        self._rebuild_side(side_key)
        self._mirror[side_key] = mir
        self.rt._steps.clear()
        return True

    def _shrink_target(self, side_key: str) -> Optional[tuple]:
        """(current Wp, target) for a side whose sub-windows growth made
        larger than its occupancy needs, else None: the target keeps the
        2x headroom growth provisions and never drops below the
        configured-slack sizing."""
        plan = self.plans[side_key]
        if not plan.use_pidx:
            return None
        need = int(self.partition_occupancy(side_key).max(initial=0))
        floor = _pow2((plan.W * self.slack + self.P - 1) // self.P)
        target = max(_pow2(2 * need), floor)
        return None if target >= plan.Wp else (plan.Wp, target)

    def shrink_candidates(self) -> Dict[str, tuple]:
        """Sides whose Wp could shrink back: {side: (wp, target)}."""
        out = {}
        for side_key in self.plans:
            t = self._shrink_target(side_key)
            if t is not None:
                out[side_key] = t
        return out

    def shrink_partitions(self) -> Dict[str, tuple]:
        """Release over-provisioned sub-window capacity through the
        directory rebuild (membership and gseq order unchanged; only the
        capacity moves). The caller holds the runtime's lock, with its
        in-flight batches drained. Returns {side: (old Wp, new Wp)}."""
        shrunk: Dict[str, tuple] = {}
        if self.rt._state is None:
            return shrunk
        for side_key, (old_wp, target) in self.shrink_candidates().items():
            self.plans[side_key].Wp = target
            self._rebuild_side(side_key)   # grows back if the ring is hotter
            shrunk[side_key] = (old_wp, self.plans[side_key].Wp)
        if shrunk:
            self.rt._steps.clear()
        return shrunk

    # -------------------------------------------------------- step build

    def build_side_step(self, side_key: str):
        """The fused ``(state, probe_cols, probe_valid, cols, now) ->
        (state, out)`` step of one side: transforms and filters, the
        window insert, the post-window filters, the insert into its own
        directory and the partition-local probe of the other side, the
        selector. The probe arguments are unused: both surfaces live in
        the state."""
        from siddhi_tpu_torch.core.query.join_runtime import (
            finish_step, live_rows, materialize_joined, outer_rows,
            overflow_bit, side_eval, window_out)

        rt = self.rt
        side = rt.sides[side_key]
        other = rt.sides["right" if side_key == "left" else "left"]
        splan = self.plans[side_key]
        oplan = self.plans["right" if side_key == "left" else "left"]
        sel, on_cond, split = rt.selector_plan, rt.on_cond, rt.keyer is not None
        P = self.P
        dev = rt.device
        xp = TorchXP(dev)
        ins_on = rt._instruments_on()

        def partition_of(cols, n, ctx):
            vals, mask = splan.key_fn(cols, ctx)
            p = hash_partition_dev(torch.as_tensor(vals, device=dev).expand(n), P)
            if mask is not None:
                p = torch.where(torch.as_tensor(mask, device=dev).expand(n),
                                torch.zeros_like(p), p)
            return p.to(torch.int64)

        def pidx_insert(pidx, cols, total0, floor_after, ctx):
            """Scatter the batch's inserted rows into the side's own
            directory (in place); returns the overflow flag."""
            Wp = splan.Wp
            valid_cur = cols[VALID_KEY] & (cols[TYPE_KEY] == CURRENT)
            B = valid_cur.shape[0]
            gseq = total0 + torch.cumsum(valid_cur.to(torch.int64), 0) - 1
            # rows evicted or expired within this very batch never enter
            # the directory (the ring drops them the same way)
            ins = valid_cur & (gseq >= floor_after)
            p = torch.where(ins, partition_of(cols, B, ctx), P)   # P: dropped
            maskp = p[None, :] == torch.arange(P, device=dev)[:, None]
            pos = torch.cumsum(maskp.to(torch.int64), 1) - 1
            pc = torch.clamp(p, 0, P - 1)
            pos_row = pos.gather(0, pc[None, :])[0]
            n_per = maskp.sum(dim=1)
            off = (pidx["cnt"][pc] + pos_row) % Wp
            keep = p < P
            flat = pc * Wp + off
            gflat = pidx["gseq"].view(-1)
            occupant = gflat[flat]
            # overwriting a live occupant (or more than Wp inserts into one
            # partition in one batch) would drop probe members: fatal
            ov = ((keep & (occupant >= floor_after) & (occupant >= 0)).any()
                  | (n_per > Wp).any())
            put_where_(gflat, 0, flat, gseq, keep)
            pidx["cnt"].add_(n_per)
            return ov

        def step(state, probe_cols, probe_valid, cols, current_time):
            ctx = {"xp": xp, "current_time": current_time}
            cols = dict(cols)
            strrank = cols.pop(STR_RANK, None)
            win = state[splan.win_key]
            if splan.use_pidx:
                # the rows the window inserts, as the window sees them, and
                # its row count before them (the window writes in place)
                cols = conform_cols(side.window_stage, cols)
                total0 = win["total"].clone()
            wout, notify, overflow = window_out(
                side, state, splan.win_key, cols, ctx, side.filters, side.transforms)
            ovbits = overflow_bit(overflow, dev)
            if splan.use_pidx:
                pov = pidx_insert(state[splan.pidx_key], cols, total0,
                                  splan.live_floor(win), ctx)
                ovbits = ovbits | torch.where(pov, 4, 0)
            N = wout[VALID_KEY].shape[0]
            row_live = live_rows(wout)
            ev = side_eval(side, wout)
            if oplan.use_pidx and side.triggers:
                # the partition-local probe: only the trigger row's hash
                # partition of the other side
                owin = state[oplan.win_key]
                cand_g = state[oplan.pidx_key]["gseq"][partition_of(wout, N, ctx)]
                cand_live = (cand_g >= oplan.live_floor(owin)) & (cand_g >= 0)
                cand_slot = torch.clamp(cand_g, min=0) % oplan.W       # [N, Wp]
                S = oplan.Wp
                # the condition gathers only the other-side columns it reads
                cond = (on_cond(_Candidates(ev, other.prefix, owin["buf"], cand_slot),
                                ctx) if on_cond is not None
                        else torch.ones((N, S), dtype=torch.bool, device=dev))
                match = row_live[:, None] & cand_live & torch.as_tensor(cond).expand(N, S)
                one_sided = outer_rows(side, wout, row_live, match)
                for a in other.definition.attributes:
                    ev[other.prefix + a.name] = owin["buf"][a.name][None, :]
                    ev[other.prefix + a.name + "?"] = owin["buf"][a.name + "?"][None, :]
                joined, r, cc, lone = materialize_joined(
                    side, other, wout, ev, match, one_sided, slots=cand_slot)
                # (trigger row, ring slot): the broadcast probe's order
                W = oplan.W
                slot = torch.where(lone, W, cand_slot[r, cc])
                okey = torch.where(joined[VALID_KEY], r * (W + 1) + slot, _BIG)
                order = torch.sort(okey, stable=True).indices
                joined = {k: v[order] for k, v in joined.items()}
            else:
                # the broadcast probe (P = 1, an untriggering side, or a
                # windowless other side)
                pcols, pvalid = other.window_stage.contents(state[oplan.win_key])
                Wo = pvalid.shape[0]
                for a in other.definition.attributes:
                    ev[other.prefix + a.name] = pcols[a.name][None, :]
                    ev[other.prefix + a.name + "?"] = pcols[a.name + "?"][None, :]
                if side.triggers:
                    cond = (on_cond(ev, ctx) if on_cond is not None
                            else torch.ones((N, Wo), dtype=torch.bool, device=dev))
                    match = (row_live[:, None] & pvalid[None, :]
                             & torch.as_tensor(cond).expand(N, Wo))
                else:
                    match = torch.zeros((N, Wo), dtype=torch.bool, device=dev)
                one_sided = outer_rows(side, wout, row_live, match)
                joined, _r, _c, _lone = materialize_joined(
                    side, other, wout, ev, match, one_sided)
            if strrank is not None:
                joined[STR_RANK] = strrank
            # every dispatched step (either side) advances ONE sequence;
            # the meta carries it for the drain-order check
            state[SEQ_KEY].add_(1)
            suffix = [state[SEQ_KEY].clone()]
            if ins_on:
                # each partitioned side's live members per partition, from
                # the directory the step holds (JoinQueryRuntime.
                # _step_instrument_slots declares the lanes)
                for plan in (self.plans["left"], self.plans["right"]):
                    if plan.use_pidx:
                        gseq = state[plan.pidx_key]["gseq"]
                        floor = plan.live_floor(state[plan.win_key])
                        suffix.append(((gseq >= floor) & (gseq >= 0)).sum(
                            dim=1, dtype=torch.int64))
            return state, finish_step(sel, state, joined, ctx, split, notify,
                                      ovbits, suffix=suffix)

        return step
