"""The host side of two-stream window joins.

Counterpart of ``siddhi_tpu/core/query/join_runtime.py`` (reference
``JoinProcessor.java`` + ``JoinInputStreamParser.java``): each side owns a
window stage; an arriving chunk is inserted into its own window first
(pre-join forwards, trigger false: ``JoinInputStreamParser.java:344``),
then every row the window emits (CURRENT and EXPIRED) probes the other
side's held rows with the compiled `on` condition (post-join trigger,
``JoinProcessor.execute:107-170``) as one masked ``[N, W]`` broadcast
compare. An outer side emits a null-padded row when nothing matches.

Beyond the plain stream-stream shape:
- group-by selectors: a host keyer over the joined columns, then the
  selector (the split pipeline, ``QueryRuntime._host_keyed_select``);
- joins inside partitions: keyed window sides, each row probing its own
  key's ``[K, W]`` ring;
- host-window sides (sort/frequent/session...): the window runs on the
  host, its ``contents()`` is the probe surface;
- store sides: a table or a named window, probed through ``contents()``;
  an equality on an indexed table attribute probes a sorted copy of the
  column with ``searchsorted`` instead (``index_probe``);
- aggregation sides (``join Agg within ... per ...``): the stitched
  buckets of one duration (host numpy, ``AggregationJoinStore``) are the
  probe surface, moved to the device once a step; an equality on a group
  attribute takes the indexed probe. Per-event ``within``/``per``
  values group the trigger rows, and each group probes its own buckets.

Eligible stream-stream joins run the partitioned engine of
``core/join/engine.py`` instead of the broadcast probe; its rows equal
the broadcast probe's row for row.

Where the reference materializes every ``[N, W+1]`` candidate of every
joined column, both probes here read the match count back once per step
and build only the matched rows (and the one-sided rows of column W), in
the same (trigger row, slot) order: the selector sees the reference's
valid rows in the reference's order, and a step's memory is its match
mask, not W+1 copies of every column.

Routed joins over a mesh wait for ROADMAP A.9
(``parallel/mesh.route_ineligibility``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from siddhi_tpu_torch.core.event import (
    CURRENT, EXPIRED, RESET, TIMER, Event, HostBatch, LazyColumns, pack_pool_of)
from siddhi_tpu_torch.core.plan.selector_plan import GK_KEY, STR_RANK
from siddhi_tpu_torch.core.query.runtime import (
    QueryRuntime, _zero_value, backfill_null_masks, pack_meta)
from siddhi_tpu_torch.core.stream.junction import (
    FatalQueryError, Receiver, current_delivering_junction)
from siddhi_tpu_torch.core.table.in_memory_table import to_device
from siddhi_tpu_torch.ops.expressions import (
    NUMPY_XP, PK_KEY, TS_KEY, TYPE_KEY, VALID_KEY, ColumnRef, CompileError,
    Resolver, TorchXP)
from siddhi_tpu_torch.ops.windows import (
    FLUSH_KEY, NOTIFY_KEY, OVERFLOW_KEY, _mask_positions, conform_cols)
from siddhi_tpu_torch.query_api.definitions import StreamDefinition
from siddhi_tpu_torch.query_api.expressions import Variable

_LOG = logging.getLogger("siddhi_tpu_torch.join")


@dataclass
class JoinSide:
    key: str                     # 'left' | 'right'
    stream_id: str
    ref_id: Optional[str]
    definition: StreamDefinition
    window_stage: object         # None for a table side
    filters: List[Callable]
    triggers: bool               # unidirectional: does this side emit?
    outer: bool                  # emit a null-padded row when no match
    # a shared probe-only store with a contents() -> (cols, valid) surface
    # (InMemoryTable / RecordTableAdapter / NamedWindowRuntime)
    store: object = None
    # a host window (sort/frequent/...): runs on the host; its contents()
    # is the probe surface, its emissions trigger the join
    host_window: object = None
    keyer: object = None         # partition keyer (partitioned joins)
    # stream-function column transforms applied before filters/window
    transforms: List = field(default_factory=list)
    # when transforms append attributes, `definition` is the extended
    # shape; ingest packs the declared one
    input_definition: Optional[StreamDefinition] = None
    # filters after the window: mask this side's emitted (trigger) rows
    post_filters: List = field(default_factory=list)
    # inside a partition: a non-partitioned stream side, one window copy
    # per key, fed every event while the key's instance exists
    global_side: bool = False
    # inner '#stream' / partition-local side: rows carry their pk
    carried_pk: bool = False

    @property
    def pack_definition(self) -> StreamDefinition:
        return self.input_definition or self.definition

    @property
    def prefix(self) -> str:
        return "l__" if self.key == "left" else "r__"

    @property
    def probe_external(self) -> bool:
        """The probe columns come from outside the runtime's state."""
        return self.store is not None or self.host_window is not None


class AggregationJoinStore:
    """Probe adapter over an incremental aggregation's stitched buckets
    (reference ``join AggName within <start>, <end> per '<duration>'``)."""

    def __init__(self, agg, duration, within: Optional[tuple]):
        self.agg = agg
        self.duration = duration
        self.within = within
        self.definition = agg.output_definition()
        self.dynamic = None      # (per_of, within_of) raw-value closures
        self.dynamic_raw = None  # uncompiled expressions (set by the planner)

    def contents(self):
        _defn, cols, valid = self.agg.contents(self.duration, self.within)
        return cols, valid

    def probe_attrs(self):
        """The group attributes: an equality on one probes the stitched
        buckets through the indexed probe (``JoinQueryRuntime``'s sorted
        column and ``searchsorted``) instead of the ``[N, W]`` compare."""
        return {a.name for a in self.agg.group_attrs}

    def max_run(self, cols, valid, attr: str) -> int:
        """The most valid rows sharing one value of ``attr``: the
        candidate window an indexed probe over these contents needs, so
        the probe never saturates (the buckets are host arrays here)."""
        v = np.asarray(cols[attr])[np.asarray(valid)]
        if v.size == 0:
            return 1
        _u, counts = np.unique(v, return_counts=True)
        return int(counts.max())

    def resolve_groups(self, cols, ctx):
        """Group trigger rows by their per-event (duration, within) values
        (``within i.startTime, i.endTime per i.perValue``); each group
        probes its own stitched-bucket surface. Timer rows and rows whose
        values don't parse ride the first group (they only advance window
        clocks — no probe of their own)."""
        from siddhi_tpu_torch.core.aggregation.incremental import parse_duration_name
        from siddhi_tpu_torch.core.aggregation.within_time import (
            bound_ms, single_within_range)

        per_of, within_of = self.dynamic
        valid = np.asarray(cols[VALID_KEY])
        is_timer = np.asarray(cols[TYPE_KEY]) == TIMER
        n = len(valid)
        pers = per_of(cols, ctx) if per_of is not None else None
        wins = within_of(cols, ctx) if within_of is not None else None
        groups: dict = {}
        carry = []
        for i in range(n):
            if not valid[i]:
                continue
            if is_timer[i]:
                carry.append(i)
                continue
            try:
                dur = parse_duration_name(pers[i]) if pers is not None \
                    else self.duration
                if wins is not None:
                    w = wins[i]
                    if isinstance(w, tuple):
                        win = (bound_ms(w[0]), bound_ms(w[1]))
                        if not win[0] < win[1]:
                            raise ValueError("within start must be < end")
                    elif isinstance(w, str):
                        win = single_within_range(w)
                    else:
                        win = (int(w), 2 ** 62)
                else:
                    win = self.within
            except Exception as e:
                # reference logs at the processor and drops the event
                _LOG.warning("aggregation join: dropping trigger row with "
                             "unresolvable within/per: %s", e)
                continue
            groups.setdefault((dur, win), []).append(i)
        if not groups:
            groups[(self.duration or parse_duration_name("seconds"),
                    self.within)] = []
        out = []
        for gi, ((dur, win), idx) in enumerate(groups.items()):
            mask = np.zeros(n, bool)
            mask[idx] = True
            if gi == 0:
                mask[carry] = True
            out.append((mask, dur, win))
        return out


class JoinResolver(Resolver):
    """Resolve selector and `on` variables to prefixed joined columns."""

    def __init__(self, left: JoinSide, right: JoinSide, dictionary):
        self.sides = [left, right]
        self.dictionary = dictionary
        self.synthetic: Dict[str, object] = {}

    def resolve(self, var: Variable) -> ColumnRef:
        if var.attribute_name in self.synthetic and var.stream_id is None:
            return ColumnRef(var.attribute_name, self.synthetic[var.attribute_name])
        sid = var.stream_id
        matches = []
        for side in self.sides:
            if sid is not None and sid not in (side.ref_id, side.stream_id):
                continue
            try:
                attr = side.definition.attribute(var.attribute_name)
            except Exception:
                continue
            matches.append((side, attr))
        if not matches:
            raise CompileError(
                f"cannot resolve '{(sid + '.') if sid else ''}{var.attribute_name}' "
                f"in join query")
        if len(matches) > 1:
            # self-joins: the raw stream id matches both sides too
            raise CompileError(
                f"'{(sid + '.') if sid else ''}{var.attribute_name}' is ambiguous "
                f"between the join sides — qualify it with the `as` reference")
        side, attr = matches[0]
        return ColumnRef(side.prefix + attr.name, attr.type)

    def encode_string(self, s: str) -> int:
        return self.dictionary.encode(s)


class JoinSideProxy(Receiver):
    """The receiver of one side of a join runtime. Beyond delivery it
    implements the fused fan-out MEMBER protocol
    (``core/query/fused_fanout.py``; the reference's
    ``join_runtime.py:216-420``): an engine-attached side fuses with
    sibling single-stream queries on a shared junction, its insert and
    probe run inside the group's one step and its meta rides the group's
    stacked pull. Its step reads its match count on the host
    (``materialize_joined``) and the engine's ``prepare_batch`` reads its
    occupancy mirror, so it is never ``capturable()``: a group holding a
    join side runs eagerly on the card."""

    _fanout_group = None
    _own_keyer = None

    def __init__(self, runtime: "JoinQueryRuntime", side_key: str):
        self.runtime = runtime
        self.side_key = side_key

    @property
    def name(self) -> str:
        return f"{self.runtime.name}.{self.side_key}"

    # ------------------------------------------------ fused member protocol

    def fusion_ineligibility(self) -> Optional[str]:
        """Why this side cannot join a fused fan-out group (None =
        eligible); consulted by ``fanout_plan.fusion_ineligibility``."""
        from siddhi_tpu_torch.core.eligibility import ReasonCode as RC
        from siddhi_tpu_torch.core.eligibility import reason

        rt = self.runtime
        if rt.engine is None:
            return reason(RC.NO_DEVICE_ENGINE,
                          f"join side without device engine ({rt.engine_reason})")
        if rt.keyer is not None:
            return reason(RC.GROUPED_SELECT,
                          "grouped join selector (split host-keyed pipeline)")
        if rt._route_layout is not None:
            return reason(RC.SHARDED, "routed join")
        for side in rt.sides.values():
            if side.window_stage is not None and getattr(
                    side.window_stage, "needs_scheduler", False):
                return reason(RC.SCHEDULER_WINDOW, "scheduler-driven join window")
        if rt.sides["left"].stream_id == rt.sides["right"].stream_id:
            # both proxies would fuse onto ONE junction sharing one state
            return reason(RC.SELF_JOIN,
                          "self-join (both sides share the junction batch)")
        return None

    def program_signature(self) -> None:
        """Never clusters: the join's other side steps the same state
        outside the group, so a shared state object would be stepped
        twice."""
        return None

    def capturable(self) -> bool:
        return False

    @property
    def app_context(self):
        return self.runtime.app_context

    @property
    def device(self):
        return self.runtime.device

    @property
    def input_definition(self):
        return self.runtime.sides[self.side_key].pack_definition

    @property
    def dictionary(self):
        return self.runtime.dictionary

    @property
    def selector_plan(self):
        return self.runtime.selector_plan

    @property
    def keyer(self):
        return self.runtime.keyer

    @keyer.setter
    def keyer(self, value):
        self.runtime.keyer = value

    @property
    def _win_keys(self):
        return self.runtime._win_keys

    @property
    def _lock(self):
        return self.runtime._lock

    @property
    def _state(self):
        return self.runtime._state

    @_state.setter
    def _state(self, value):
        self.runtime._state = value

    @property
    def scheduler(self):
        return self.runtime.scheduler

    @property
    def _timer_cb(self):
        # a fused side's wake time re-enters through ITS side's timer
        return self.runtime._timer_cbs[self.side_key]

    def _ensure_capacity(self):
        self.runtime._ensure_capacity()

    def _init_state(self):
        return self.runtime._init_state()

    def prepare_cols(self, cols) -> bool:
        """The group's pre-dispatch hook: the engine's sub-window growth
        for this side's batch (as ``process_side_batch`` calls it). True =
        the state's shapes changed and the group must rebuild its step."""
        rt = self.runtime
        if rt._state is None:
            rt._state = rt._init_state()
        return rt.engine.prepare_batch(self.side_key, cols)

    def overflow_knob_msg(self, code: Optional[int] = None) -> str:
        # the overflow lane is a bitmask: the fused drain names its knob
        return self.runtime.overflow_knob_msg(code)

    def decode_meta_suffix(self, meta) -> None:
        self.runtime.decode_meta_suffix(meta)

    def _emit(self, out: HostBatch):
        self.runtime._emit(out)

    def build_step_fn(self):
        """The side's member step: the engine's probe surfaces live in
        the state, so the probe arguments of the side step are unused."""
        step = self.runtime.build_side_step_fn(self.side_key)

        def fn(state, cols, now):
            return step(state, {}, None, cols, now)

        return fn

    # ---------------------------------------------------------- delivery

    def receive(self, events: List[Event]):
        rt = self.runtime
        side = rt.sides[self.side_key]
        if side.carried_pk:
            # an inner '#stream' / partition-local side: rows keep the
            # producing instance's pk. Events WITHOUT a pk (a global
            # junction anyone can feed) reach every active instance, like
            # a global side's.
            keyed = [e for e in events if e.pk is not None]
            bare = [e for e in events if e.pk is None]
            n = rt.partition_ctx.active_keys() if rt.partition_ctx is not None else 0
            for group in (keyed, [Event(timestamp=e.timestamp, data=e.data,
                                        is_expired=e.is_expired, pk=k)
                                  for e in bare for k in range(n)]):
                if group:
                    batch = HostBatch.from_events(
                        group, side.pack_definition, rt.dictionary)
                    pk = np.zeros(batch.capacity, np.int32)
                    pk[:len(group)] = [e.pk for e in group]
                    batch.cols[PK_KEY] = pk
                    rt.process_side_batch(self.side_key, batch)
            return
        batch = HostBatch.from_events(
            events, side.pack_definition, rt.dictionary,
            pool=pack_pool_of(rt.app_context))
        rt.process_side_batch(self.side_key, batch)

    def receive_batch(self, batch: HostBatch, junction=None):
        side = self.runtime.sides[self.side_key]
        if side.carried_pk and PK_KEY not in batch.cols:
            self.receive(junction.decode_events(batch))
            return
        backfill_null_masks(batch, side.pack_definition)
        self.runtime.process_side_batch(self.side_key, batch, junction=junction)


def materialize_joined(side: JoinSide, other: JoinSide, wout: dict, ev: dict,
                       match: torch.Tensor, one_sided: torch.Tensor,
                       pk: Optional[torch.Tensor] = None,
                       slots: Optional[torch.Tensor] = None):
    """The joined rows of a probe: the matched pairs of ``match`` ``[N,
    S]`` and the one-sided rows ``one_sided`` ``[N]`` (column S, the other
    side null), in the row-major order of the reference's ``[N, S+1]``
    materialization. One host read of the count sizes them; the rows
    carry the trigger row as their flush chunk (one reference chunk per
    trigger event). The other side's values come from ``ev`` (``[., S]``
    columns), or, given ``slots`` ``[N, S]``, from the ``[1, W]`` ring
    columns in ``ev`` at those slots. Returns (joined columns, trigger
    row of each, probe column of each, one-sided flags)."""
    N, S = match.shape
    dev = match.device
    full = torch.cat([match, one_sided[:, None]], dim=1)
    n = int(full.sum())            # the host read that sizes the rows
    m = max(n, 1)                  # an empty probe keeps one invalid row
    pos = (_mask_positions(full, n) if n
           else torch.zeros(1, dtype=torch.int64, device=dev))
    r = torch.div(pos, S + 1, rounding_mode="floor")
    c = pos - r * (S + 1)
    lone = c == S
    cc = torch.clamp(c, max=max(S - 1, 0))
    joined: Dict[str, torch.Tensor] = {}
    for a in side.definition.attributes:
        joined[side.prefix + a.name] = wout[a.name][r]
        joined[side.prefix + a.name + "?"] = wout[a.name + "?"][r]
    col = slots[r, cc] if (slots is not None and S) else None
    for a in other.definition.attributes:
        pc = ev[other.prefix + a.name]
        pm = ev[other.prefix + a.name + "?"]
        if S == 0:
            joined[other.prefix + a.name] = torch.zeros(m, dtype=pc.dtype, device=dev)
            joined[other.prefix + a.name + "?"] = torch.ones(m, dtype=torch.bool, device=dev)
            continue
        if col is not None:
            v, vm = pc[0][col], pm[0][col]
        else:
            v, vm = pc.expand(N, S)[r, cc], pm.expand(N, S)[r, cc]
        joined[other.prefix + a.name] = torch.where(lone, torch.zeros_like(v), v)
        joined[other.prefix + a.name + "?"] = vm | lone
    joined[VALID_KEY] = torch.arange(m, device=dev) < n
    joined[TS_KEY] = wout[TS_KEY][r]
    joined[TYPE_KEY] = wout[TYPE_KEY][r]
    if pk is not None:
        joined[PK_KEY] = pk[r].to(torch.int32)
        joined[GK_KEY] = joined[PK_KEY]
    else:
        joined[GK_KEY] = torch.zeros(m, dtype=torch.int32, device=dev)
    joined[FLUSH_KEY] = r.to(torch.int32)
    return joined, r, cc, lone


def window_out(side: JoinSide, state: dict, win_key: str, cols: dict, ctx: dict,
               filters, transforms):
    """One side's pre-probe stages: transforms and filters, the window
    insert (its state updated in place), the post-window filters. Returns
    (emitted rows, notify, overflow)."""
    cols = dict(cols)
    for t in transforms:
        cols = t.apply(cols, ctx)
    valid = cols[VALID_KEY]
    timer = cols[TYPE_KEY] == TIMER
    for f in filters:
        valid = valid & (f(cols, ctx) | timer)
    cols[VALID_KEY] = valid
    _st, wout = side.window_stage.apply(
        state.get(win_key), conform_cols(side.window_stage, cols), ctx)
    wout = dict(wout)
    notify = wout.pop(NOTIFY_KEY, None)
    overflow = wout.pop(OVERFLOW_KEY, None)
    wout.pop(FLUSH_KEY, None)
    # post-window filters mask the emitted (trigger) rows only
    pvalid = wout[VALID_KEY]
    ptimer = wout[TYPE_KEY] == TIMER
    for f in side.post_filters:
        pvalid = pvalid & (f(wout, ctx) | ptimer)
    wout[VALID_KEY] = pvalid
    return wout, notify, overflow


def side_eval(side: JoinSide, wout: dict) -> dict:
    """This side's emitted rows as the ``[N, 1]`` half of a probe's eval
    dict (the other side supplies the ``[., S]`` half)."""
    ev = {TS_KEY: wout[TS_KEY][:, None]}
    for a in side.definition.attributes:
        ev[side.prefix + a.name] = wout[a.name][:, None]
        ev[side.prefix + a.name + "?"] = wout[a.name + "?"][:, None]
    return ev


def live_rows(wout: dict) -> torch.Tensor:
    t = wout[TYPE_KEY]
    return wout[VALID_KEY] & ((t == CURRENT) | (t == EXPIRED))


def outer_rows(side: JoinSide, wout: dict, row_live, match) -> torch.Tensor:
    """Column S of the probe: an outer side's unmatched live rows, and the
    RESET rows of a windowless side (they restart per-trigger aggregates)."""
    reset = wout[VALID_KEY] & (wout[TYPE_KEY] == RESET)
    if side.outer and side.triggers:
        return (row_live & ~match.any(dim=1)) | reset
    return reset


def finish_step(sel, state: dict, joined: dict, ctx: dict, split: bool,
                notify, ovbits: torch.Tensor, suffix=()) -> dict:
    """The selector over the joined rows (or, with a host group keyer,
    the joined rows themselves), packed with the meta: [overflow bitmask,
    notify, count] then ``suffix`` (the engine's sequence lane)."""
    if split:
        out = joined
    else:
        _st, out = sel.apply(state["sel"], joined, ctx)
        sel_ov = out.pop(OVERFLOW_KEY, None)
        if sel_ov is not None:
            ovbits = ovbits | torch.where(
                torch.as_tensor(sel_ov).to(torch.int64) > 0, 8, 0)
    if notify is not None:
        out[NOTIFY_KEY] = notify
    out[OVERFLOW_KEY] = ovbits
    out = pack_meta(out)
    if suffix:
        out["__meta__"] = torch.cat([out["__meta__"]] + [s.reshape(1) for s in suffix])
    return out


def overflow_bit(overflow, dev) -> torch.Tensor:
    """Bit 1 of a join step's overflow bitmask: the window ring's own."""
    if overflow is None:
        return torch.zeros((), dtype=torch.int64, device=dev)
    return (torch.as_tensor(overflow) > 0).to(torch.int64)


class JoinQueryRuntime(QueryRuntime):
    def __init__(self, name, app_context, left: JoinSide, right: JoinSide,
                 on_cond: Optional[Callable], selector_plan, dictionary,
                 partition_ctx=None, group_keyer=None):
        super().__init__(
            name=name, app_context=app_context, input_definition=None,
            filters=[], window_stage=None, selector_plan=selector_plan,
            keyer=group_keyer, dictionary=dictionary,
            partition_ctx=partition_ctx)
        self.sides = {"left": left, "right": right}
        self.on_cond = on_cond
        # the planner's indexed-equality probe of a table side (None =
        # broadcast compare): {"store_side", "attr", "val_fn", "residual_fn"}
        self.index_probe = None
        self._steps: Dict[str, Callable] = {}
        # the partitioned engine (core/join/), attached by the planner for
        # eligible stream-stream shapes; None keeps the broadcast probe
        self.engine = None
        self.engine_reason: Optional[str] = "engine not attached"
        self.pipeline_reason: Optional[str] = "engine not attached"
        self._in_timer = False       # timer sweeps run synchronously
        self._drain_seq = None       # last cross-stream seq seen at drain
        self.seq_breaks = 0
        self._cur_timer_cb = None    # the side's wake-time target (pump)
        # one stable timer callback per side: the scheduler dedupes
        # requests by (target, time)
        self._timer_cbs = {
            k: (lambda ts, sk=k: self._timer(sk, ts)) for k in ("left", "right")}
        # pinned staging per side: the sides' columns differ
        self._side_staging: Dict[str, object] = {}

    def make_proxies(self) -> Dict[str, JoinSideProxy]:
        """One receiver per side with a window stage (a table side
        produces no events)."""
        self._proxies = {
            k: JoinSideProxy(self, k) for k in ("left", "right")
            if self.sides[k].window_stage is not None}
        return self._proxies

    def _init_state(self) -> dict:
        dev = self.device
        state = {"sel": self.selector_plan.init_state(dev)}
        for k, wk in (("left", "lwin"), ("right", "rwin")):
            side = self.sides[k]
            if side.window_stage is not None and side.host_window is None:
                state[wk] = side.window_stage.init_state(self._win_keys, dev)
        if self.engine is not None:
            state.update(self.engine.init_pidx_state())
        return state

    def strip_engine_state(self, state):
        """A snapshot's form of the state: the engine's partition
        directories and cross-stream sequence are derived, so a capture
        keeps only the ``[W]`` rings, and revisions cross-restore between
        the engine and the broadcast probe (and across
        ``siddhi_tpu.join_partitions`` values)."""
        if state is None or self.engine is None:
            return state
        from siddhi_tpu_torch.core.join import ENGINE_STATE_KEYS

        return {k: v for k, v in state.items() if k not in ENGINE_STATE_KEYS}

    def adopt_restored_state(self):
        """After state is installed from outside (``interop``): the
        engine's partition directories are derived state, rebuilt from
        the rings, and the drain sequence restarts."""
        self._drain_seq = None
        self._steps.clear()
        if self.engine is not None and self._state is not None:
            self.engine.rebuild_probe_state()

    def _seq_check(self, seq: int) -> None:
        """Drain-side check of the engine's cross-stream sequence: the
        pump's per-owner FIFO must hand batches back in dispatch order; a
        gap is an ordering fault, which is logged and counted. Skipped
        while a side rides a fused fan-out group: its sequence numbers
        drain through the GROUP's entries, so this runtime's own FIFO sees
        gaps (no order is promised across owners)."""
        if any(p._fanout_group is not None
               for p in getattr(self, "_proxies", {}).values()):
            self._drain_seq = None
            return
        exp = self._drain_seq
        self._drain_seq = seq
        if exp is not None and seq != exp + 1:
            _LOG.error("query '%s': join drain sequence break (expected %d, "
                       "got %d) — cross-stream emission order violated",
                       self.name, exp + 1, seq)
            self.seq_breaks += 1

    def decode_meta_suffix(self, meta) -> None:
        if self.engine is not None and len(meta) > 3:
            self._seq_check(int(meta[3]))

    def _ensure_capacity(self):
        before = (self.selector_plan.num_keys, self._win_keys)
        super()._ensure_capacity()
        if (self.selector_plan.num_keys, self._win_keys) != before:
            self._steps.clear()

    def overflow_knob_msg(self, code: Optional[int] = None) -> str:
        """The knob a join step's overflow bitmask names: 1 = window ring
        capacity, 2 = indexed probe candidate window, 4 = partition
        sub-window, 8 = selector value table (distinctCount)."""
        code = 1 if code is None else int(code)
        parts = []
        if code & 1:
            knob = ("siddhi_tpu.partition_window_capacity"
                    if self.partition_ctx is not None
                    else "siddhi_tpu.window_capacity")
            parts.append(f"join window capacity exceeded — raise {knob}")
        if code & 2:
            parts.append("indexed join probe candidate window saturated — "
                         "raise siddhi_tpu.index_probe_width")
        if code & 4:
            parts.append("join partition sub-window overflow — raise "
                         "siddhi_tpu.join_partition_slack (or lower "
                         "siddhi_tpu.join_partitions)")
        if code & 8:
            parts.append("join selector aggregation overflow — raise "
                         "app_context.distinct_values_capacity")
        if not parts:
            parts.append("join window capacity exceeded — raise "
                         "siddhi_tpu.window_capacity")
        return "; ".join(parts)

    # ------------------------------------------------------------ the step

    def build_side_step_fn(self, side_key: str):
        """The ``(state, probe_cols, probe_valid, cols, now) -> (state,
        out)`` step of one side: its window insert, then the probe of the
        other side (broadcast, per partition key, or through the indexed
        table probe), then the selector. The engine's step when one is
        attached."""
        if self.engine is not None:
            return self.engine.build_side_step(side_key)
        side = self.sides[side_key]
        other = self.sides["right" if side_key == "left" else "left"]
        win_key = "lwin" if side_key == "left" else "rwin"
        other_key = "rwin" if side_key == "left" else "lwin"
        sel = self.selector_plan
        on_cond = self.on_cond
        # a host-window side ran its transforms and filters on the host
        host_pre = side.host_window is not None
        filters = [] if host_pre else side.filters
        transforms = [] if host_pre else side.transforms
        partitioned = self.partition_ctx is not None
        split = self.keyer is not None
        other_external = other.probe_external
        # the indexed probe: only when THIS side triggers against the
        # indexed table side (a table never triggers)
        iprobe = self.index_probe
        use_index = (iprobe is not None and side.triggers
                     and iprobe["store_side"] == other.key
                     and other.store is not None and not partitioned)
        probe_width = int(getattr(self.app_context, "index_probe_width", 64))
        xp = TorchXP(self.device)

        def step(state, probe_cols, probe_valid, cols, current_time,
                 agg_width=None):
            # agg_width: an aggregation side's indexed-probe window
            ctx = {"xp": xp, "current_time": current_time}
            cols = dict(cols)
            strrank = cols.pop(STR_RANK, None)
            wout, notify, overflow = window_out(
                side, state, win_key, cols, ctx, filters, transforms)
            ovbits = overflow_bit(overflow, self.device)
            N = wout[VALID_KEY].shape[0]
            if not other_external:
                probe_cols, probe_valid = other.window_stage.contents(state[other_key])
            ev = side_eval(side, wout)
            row_live = live_rows(wout)
            if use_index:
                # sort the probe column once (invalid and null rows last);
                # each event's searchsorted range is its candidate window:
                # O(W log W + N log W + N*G), not the [N, W] compare
                attr = iprobe["attr"]
                v, vmask = iprobe["val_fn"](ev, ctx)
                pvals = probe_cols[attr]
                ok = probe_valid
                pnull = probe_cols.get(attr + "?")
                if pnull is not None:
                    ok = ok & ~pnull
                big = (float("inf") if pvals.is_floating_point()
                       else torch.iinfo(pvals.dtype).max)
                sortkey = torch.where(ok, pvals, torch.full_like(pvals, big))
                sk, order = torch.sort(sortkey, stable=True)
                Wfull = sk.shape[0]
                vv = torch.as_tensor(v, device=self.device).expand(N, 1)[:, 0].to(pvals.dtype)
                lo = torch.searchsorted(sk, vv, right=False)
                hi = torch.searchsorted(sk, vv, right=True)
                G = min(agg_width or probe_width, Wfull)
                grid = lo[:, None] + torch.arange(G, device=self.device)[None, :]
                cmask = grid < hi[:, None]
                if vmask is not None:
                    cmask = cmask & ~torch.as_tensor(vmask, device=self.device).expand(N, 1)
                ovbits = ovbits | torch.where(((hi - lo) > G).any(), 2, 0)
                cand = order[torch.clamp(grid, 0, Wfull - 1)]          # [N, G]
                for a in other.definition.attributes:
                    ev[other.prefix + a.name] = probe_cols[a.name][cand]
                    ev[other.prefix + a.name + "?"] = probe_cols[a.name + "?"][cand]
                # an equality re-check on the gathered rows guards the
                # dtype-max/inf sentinel (a probe value equal to it would
                # otherwise sweep deleted or null rows in)
                pv = cmask & ok[cand] & (pvals[cand] == vv[:, None])
                rfn = iprobe["residual_fn"]
                cond = (rfn(ev, ctx) if rfn is not None
                        else torch.ones((N, G), dtype=torch.bool, device=self.device))
                match = row_live[:, None] & pv & torch.as_tensor(cond).expand(N, G)
            else:
                if partitioned and not other_external:
                    # each row probes its own key's ring: [N, W]
                    K = probe_valid.shape[0]
                    pk_rows = torch.clamp(wout[PK_KEY].to(torch.int64), 0, K - 1)
                    probe_cols = {a: c[pk_rows] for a, c in probe_cols.items()}
                    pv = probe_valid[pk_rows]
                else:
                    pv = probe_valid[None, :]
                for a in other.definition.attributes:
                    pc = probe_cols[a.name]
                    ev[other.prefix + a.name] = pc if pc.dim() == 2 else pc[None, :]
                    pm = probe_cols[a.name + "?"]
                    ev[other.prefix + a.name + "?"] = pm if pm.dim() == 2 else pm[None, :]
                W = pv.shape[1]
                if side.triggers:
                    cond = (on_cond(ev, ctx) if on_cond is not None
                            else torch.ones((N, W), dtype=torch.bool, device=self.device))
                    match = row_live[:, None] & pv & torch.as_tensor(cond).expand(N, W)
                else:
                    match = torch.zeros((N, W), dtype=torch.bool, device=self.device)
            one_sided = outer_rows(side, wout, row_live, match)
            joined, _r, _c, _lone = materialize_joined(
                side, other, wout, ev, match, one_sided,
                pk=wout[PK_KEY] if partitioned else None)
            if strrank is not None:
                joined[STR_RANK] = strrank
            return state, finish_step(sel, state, joined, ctx, split, notify, ovbits)

        return step

    # ------------------------------------------------------------ the host

    def process_side_batch(self, side_key: str, batch: HostBatch, junction=None):
        notify_host = None
        with self._lock:
            j = junction or current_delivering_junction()
            self._cur_junction = j
            self._cur_fault_batch = batch if (
                j is not None and j.on_error_action == "STREAM"
                and j.fault_junction is not None) else None
            self._cur_timer_cb = self._timer_cbs[side_key]
            side = self.sides[side_key]
            cols = LazyColumns(batch.cols)
            if self.partition_ctx is not None:
                cols = self._partition_rows(side, dict(cols), batch.capacity)
            if side.host_window is not None:
                now_h = self._now()
                hctx = {"xp": NUMPY_XP, "current_time": now_h}
                cols = {k: cols[k] for k in list(cols)}   # one host read
                for t in side.transforms:
                    cols = t.apply(cols, hctx)
                cols = dict(cols)
                timer = np.asarray(cols[TYPE_KEY]) == TIMER
                valid = np.asarray(cols[VALID_KEY])
                for f in side.filters:
                    valid = valid & (np.asarray(f(cols, hctx)) | timer)
                cols[VALID_KEY] = valid
                hb, notify_host = side.host_window.process(HostBatch(cols), now_h)
                cols = hb.cols
            cols = dict(cols)
            cols[GK_KEY] = np.zeros(cols[VALID_KEY].shape[0], np.int32)
            if self._state is None:
                self._state = self._init_state()
            if self.engine is not None:
                # grow the side's partition sub-windows before the step
                # could overflow them (clears the built steps when it does)
                self.engine.prepare_batch(side_key, cols)
            step = self._steps.get(side_key)
            if step is None:
                # the side step through the step instrument: compile
                # events and costs; it reads its match count back on the
                # host (materialize_joined), so it stays eager and shares
                # nothing (analysis/step_registry.py)
                step = self._steps[side_key] = self.app_context.telemetry.instrument_jit(
                    self.build_side_step_fn(side_key), f"join.{self.name}.{side_key}",
                    family=f"device_join.{side_key}")
            other = self.sides["right" if side_key == "left" else "left"]
            self._staging = self._side_staging.get(side_key)
            try:
                if getattr(other.store, "dynamic", None) is not None:
                    notify = self._probe_dynamic_aggregation(step, other, cols)
                else:
                    notify = None
                    probe = self._probe_surface(other)
                    if probe is not None:
                        notify = self._probe_step(step, other, *probe, cols)
            finally:
                self._side_staging[side_key] = self._staging
        if notify_host is not None:
            notify = notify_host if notify is None else min(notify, notify_host)
        if notify is not None and self.scheduler is not None:
            self.scheduler.notify_at(notify, self._timer_cbs[side_key])

    def _probe_surface(self, other: JoinSide):
        """The other side's probe columns and valid mask (host arrays or
        placeholders when the step reads its own state); None when an
        aggregation side cannot serve the query's duration: the reference
        logs at the stream processor and drops the trigger events
        (Aggregation1TestCase test22)."""
        if other.store is not None:
            try:
                return other.store.contents()
            except CompileError as e:
                _LOG.error("query '%s': %s — dropping trigger events",
                           self.name, e)
                return None
        if other.host_window is not None:
            return other.host_window.contents()
        return {}, None

    def _probe_step(self, step, other: JoinSide, probe_cols, probe_valid, cols):
        """One side step against the other side's probe surface; returns
        its notify time. An aggregation side's indexed probe takes a
        candidate window as wide as its longest run of equal keys."""
        iprobe = self.index_probe
        # only this runtime's own step takes the width (the engine's does not)
        kw = {}
        if (isinstance(other.store, AggregationJoinStore) and iprobe is not None
                and iprobe["store_side"] == other.key):
            kw["agg_width"] = other.store.max_run(probe_cols, probe_valid, iprobe["attr"])
        dev = self.device
        probe_cols = {k: to_device(v, dev) for k, v in probe_cols.items()}
        if probe_valid is not None:
            probe_valid = to_device(probe_valid, dev).to(torch.bool)

        def call(st, c, now):
            return step(st, probe_cols, probe_valid, c, now, **kw)

        return self._finish_device_batch(call, cols, self.overflow_knob_msg)

    def _probe_dynamic_aggregation(self, step, other: JoinSide, cols):
        """Per-event ``within``/``per``: the trigger rows grouped by their
        resolved (duration, within), each group probing its own stitched
        buckets; the planner's static view is put back after the batch."""
        from siddhi_tpu_torch.core.table.in_memory_table import host

        store = other.store
        hcols = {k: host(v) for k, v in cols.items()}
        groups = store.resolve_groups(
            hcols, {"xp": NUMPY_XP, "current_time": self._now()})
        base_valid = hcols[VALID_KEY]
        saved = (store.duration, store.within)
        notify = None
        try:
            for mask, dur, win in groups:
                store.duration, store.within = dur, win
                probe = self._probe_surface(other)
                if probe is None:
                    continue
                sub = dict(cols)
                sub[VALID_KEY] = base_valid & mask
                n = self._probe_step(step, other, *probe, sub)
                if n is not None:
                    notify = n if notify is None else min(notify, n)
        finally:
            store.duration, store.within = saved
        return notify

    def _partition_rows(self, side: JoinSide, cols: dict, capacity: int) -> dict:
        """A side's rows inside a partition with their pk column: keyed by
        the side's partition keyer, carried (inner and partition-local
        streams), or, for a non-partitioned stream, one copy of every row
        per key, live only for the keys that exist at arrival (a later
        instance must not see earlier global events: JoinPartitionTestCase
        test10)."""
        if side.keyer is not None:
            cols, pk = side.keyer.apply(LazyColumns(cols))
            cols = dict(cols)
            cols[PK_KEY] = np.asarray(pk, np.int32)
        elif side.global_side:
            # capacity grows before K is read, so growth precedes the tile
            self._ensure_capacity()
            n_active = self.partition_ctx.active_keys()
            K = self._win_keys
            lazy = LazyColumns(cols)   # one host read of the batch
            rep = {name: np.repeat(np.asarray(lazy[name]), K, axis=0)
                   for name in list(lazy)}
            pk_tile = np.tile(np.arange(K, dtype=np.int32), capacity)
            rep[PK_KEY] = pk_tile
            rep[VALID_KEY] = rep[VALID_KEY] & (pk_tile < n_active)
            return rep
        elif PK_KEY not in cols:
            cols[PK_KEY] = np.zeros(capacity, np.int32)
        self._ensure_capacity()
        return cols

    @property
    def _pipeline_ok(self) -> bool:
        # a join whose probe surfaces live in its state rides the pump
        # (core/join/ decides: pipeline_reason None); both sides share one
        # owner FIFO, so cross-stream emission order is dispatch order (the
        # engine's sequence lane checks it at drain). Timer sweeps stay
        # synchronous.
        return self.pipeline_reason is None and not self._in_timer

    def _finish_device_batch(self, step, cols, overflow_msg=None) -> Optional[int]:
        if self.keyer is None:
            return super()._finish_device_batch(step, cols, overflow_msg)
        # the split (host-keyed) path: synchronous
        from siddhi_tpu_torch.core.util.statistics import latency_t0, record_elapsed_ms

        sm = self.app_context.statistics_manager
        t0 = latency_t0(sm)
        now = self._now()
        self._state, out = step(self._state, self._to_device(cols), now)
        out_host = LazyColumns(out)
        meta = out_host.pop("__meta__")
        self.decode_meta_suffix(meta)
        if int(meta[0]) > 0:
            raise FatalQueryError(
                f"query '{self.name}': {self.overflow_knob_msg(int(meta[0]))} "
                f"before creating the runtime")
        record_elapsed_ms(sm, self.name, t0)
        size = int(meta[2])
        if size > 0:
            out_host, size = self._host_keyed_select(out_host)
        self._emit(HostBatch(out_host, size=size))
        return int(meta[1]) if int(meta[1]) >= 0 else None

    def _timer(self, side_key: str, ts: int):
        """A side window's timer: a one-row TIMER chunk through that side,
        run synchronously after the query's in-flight batches (it runs at
        the app clock, as the reference's join timer does)."""
        side = self.sides[side_key]
        batch = HostBatch.from_events(
            [Event(timestamp=int(ts),
                   data=[_zero_value(a.type) for a in side.pack_definition.attributes])],
            side.pack_definition, self.dictionary)
        batch.cols[TYPE_KEY][...] = TIMER
        with self._device_scope(), self._lock:
            if self.app_context.stopped:
                return    # shutdown has dropped (or is dropping) the state
            pump = self.app_context.completion_pump
            if pump.has_pending:
                pump.flush_owner(self)
            self._in_timer = True
            try:
                self.process_side_batch(side_key, batch)
            finally:
                self._in_timer = False

    def receive(self, events: List[Event]):  # pragma: no cover — proxies only
        raise RuntimeError("join queries receive through per-side proxies")
