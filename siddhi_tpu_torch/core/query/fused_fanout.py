"""FusedFanoutRuntime: one dispatch per junction batch, not one per query.

Counterpart of ``siddhi_tpu/core/query/fused_fanout.py``. The junction
delivers each batch to its receivers in turn; unfused, every subscribed
``QueryRuntime`` runs its own staging copies, its own group keyer, its own
step of a few hundred torch ops and its own ``__meta__`` pull: N queries
on one stream pay N of each per batch. A fused group subscribes ONE
receiver in the members' place: the shared batch feeds a single step over
every member's state, whose output packs every member's columns plus one
stacked ``[n, 3+]`` meta, pulled once a batch.

How the step runs:

- **on the card, as one CUDA graph replay** (``core/query/step_graph.py``;
  the batch that captures runs eagerly) when every member declares its
  step capturable
  (``QueryRuntime.capturable``: each stage makes no host read and takes
  the clock as a tensor). The gauge ``fanout.<stream>.captured`` counts
  the stream's groups in this mode;
- **eagerly otherwise**: on the CPU (the tests), and on the card for a
  group with a member whose step reads the host (a join side, whose step
  reads its match count; an ``externalTime`` window, which reads the
  length of its emission). The group still makes one stacked meta pull a
  batch. The mode follows from the declarations alone: a capture or
  launch that fails raises, and nothing falls back silently.

Reference semantics kept per member:

- **subscription-order emission**: members emit in the order they
  subscribed (the group occupies the first member's receiver slot);
- **state identity**: each member keeps its own state under its own name
  and lock, so snapshots keep the unfused layout (a revision persisted
  unfused restores into a fused runtime and the reverse);
- **per-member error attribution**: a member's overflow raises a
  ``FatalQueryError`` naming that query and its knob; under
  ``@OnError(action='stream')`` only that member's failure reaches the
  fault stream, and the other members' outputs of the same batch emit;
- **group-key sharing**: members whose group-by expressions match share
  one ``GroupKeyer`` (``fanout_plan.keyer_signature``); the member's own
  keyer is kept in ``_own_keyer``, so a restore that brings divergent
  maps un-shares them;
- **identical-program dedup**: members whose programs are provably
  identical (equal ``program_signature()``, the same group-key slot) and
  whose current states are bit-equal run as ONE computation, and every
  member of the cluster is handed its outputs.

Departures from the reference:

- states are updated in place (the reference's are immutable pytrees), so
  a cluster's members hold the LEADER's state object, and only the
  leader's step runs; a member leaving the cluster (release, dissolve, a
  rebuild that splits it) gets a clone;
- released members get a copy of the shared keyer's map, so their group
  ids stay aligned with their state rows;
- ``lower_hlo_text`` (the reference's HLO audit of the fused module) has
  no counterpart: a CUDA graph has no text form to audit;
- each member counts a ``jit`` hit on every batch, the batch that builds
  (or captures) the step included; the reference skips that batch.

Telemetry: the group's step goes through the step instrument
(``observability/telemetry.InstrumentedJit``, family ``fused_fanout``):
building it, and on the card capturing it, is one compile under jit key
``fanout.<stream>.step`` with its wall ms, and an equal group of another
app (the same members' programs and clusters, the same constants)
shares its program-cache entry and graphs (``core/util/program_cache.py``)
and records a hit instead; each member counts one hit for every batch the
group dispatches. Counters
``fanout.<stream>.dispatches`` and ``fanout.<stream>.meta_pulls``, gauges
``fanout.<stream>.group_size``, ``unique_programs`` and ``captured``
(``observability/export.py`` renders them).
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.analysis.locks import make_lock
from siddhi_tpu_torch.core.event import HostBatch, LazyColumns, pack_pool_of
from siddhi_tpu_torch.core.plan.selector_plan import GK_KEY, STR_RANK
from siddhi_tpu_torch.core.query.completion import FusedCompletion, stage_meta
from siddhi_tpu_torch.core.query.runtime import QueryRuntime, backfill_null_masks
from siddhi_tpu_torch.core.query.step_graph import StepGraph, clone_tree
from siddhi_tpu_torch.core.stream.junction import (
    FatalQueryError, Receiver, current_delivering_junction)
from siddhi_tpu_torch.observability import journey
from siddhi_tpu_torch.observability.tracing import span
from siddhi_tpu_torch.ops.expressions import VALID_KEY

_FGK = "__fgk{}__"   # per-slot shared group-key columns in the fused step


def _groups_of(junction) -> List["FusedFanoutRuntime"]:
    """Live fused groups subscribed to ``junction`` (an ineligible
    receiver mid-run can split one stream into two groups)."""
    return [r for r in junction.receivers if isinstance(r, FusedFanoutRuntime)]


def _tensors_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.is_floating_point():
        return bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())
    return bool(torch.equal(x, y))


def _states_equal(sa, sb) -> bool:
    """Bit-equality of two state trees: the same junction history and the
    same program give the same trajectory, and this check makes the
    sharing verified rather than assumed."""
    if sa is sb:
        return True
    if isinstance(sa, dict) and isinstance(sb, dict):
        return sa.keys() == sb.keys() and all(_states_equal(sa[k], sb[k]) for k in sa)
    if isinstance(sa, (list, tuple)) and isinstance(sb, (list, tuple)):
        return len(sa) == len(sb) and all(_states_equal(a, b) for a, b in zip(sa, sb))
    if isinstance(sa, torch.Tensor) and isinstance(sb, torch.Tensor):
        return _tensors_equal(sa, sb)
    return type(sa) is type(sb) and sa == sb


class FusedFanoutRuntime(Receiver):
    def __init__(self, junction, members: List):
        self.junction = junction
        self.members = list(members)
        self.app_context = members[0].app_context
        self.device = self.app_context.device
        self.stream_id = junction.definition.id
        self.input_definition = members[0].input_definition
        self.dictionary = members[0].dictionary
        self._needs_rank = any(m.selector_plan.needs_str_rank for m in self.members)
        self._step = None
        self._sig = None          # (slots, per-member key capacities)
        self._clusters: List[List[int]] = []   # member idxs per computation
        self._cluster_of: List[int] = []       # member idx -> cluster idx
        self._lock = make_lock("owner")
        self._staging = None      # eager mode on the card: pinned staging
        # the group's private graphs (the program cache off, or full); a
        # group whose program is shared replays the cache entry's
        self._graph = StepGraph(self.device) if self.device.type == "cuda" else None
        self.captured = self.device.type == "cuda" and self.capturable()
        for m in self.members:
            m._fanout_group = self
        junction.replace_receivers(self.members, self)
        self.alias_keyers()
        # per-STREAM gauges over every live group on the junction (an
        # ineligible receiver can split a stream into two groups): computed
        # from the live receiver list, so a second group's registration or
        # a sibling's dissolve cannot corrupt them
        tel = self.app_context.telemetry
        tel.gauge(f"fanout.{self.stream_id}.group_size",
                  lambda j=junction: sum(len(g.members) for g in _groups_of(j)))
        tel.gauge(f"fanout.{self.stream_id}.unique_programs",
                  lambda j=junction: sum(len(g._clusters) or len(g.members)
                                         for g in _groups_of(j)))
        tel.gauge(f"fanout.{self.stream_id}.captured",
                  lambda j=junction: sum(1 for g in _groups_of(j) if g.captured))

    def capturable(self) -> bool:
        """Every member's step may run inside a CUDA graph (its stages'
        declarations; on the card the group then runs as one replay)."""
        return bool(self.members) and all(m.capturable() for m in self.members)

    @property
    def graph(self):
        """The graphs the group's replays run on: its program-cache
        entry's when its program is shared, else its own."""
        graph = getattr(self._step, "graph", None)
        return graph if graph is not None else self._graph

    # ------------------------------------------------------ keyer sharing

    def alias_keyers(self):
        """Share one GroupKeyer across members with identical group-by
        expressions AND identical current maps (identical by construction
        on a fresh runtime; a restore may bring divergent maps, which stay
        private). The member's own keyer survives in ``_own_keyer`` for a
        restore to write into."""
        from siddhi_tpu_torch.core.plan.fanout_plan import keyer_signature

        leaders = {}
        for m in self.members:
            if m._own_keyer is None:
                m._own_keyer = m.keyer
            sig = keyer_signature(m)
            if sig is None or m.keyer is None:
                continue
            lead = leaders.get(sig)
            if lead is None:
                leaders[sig] = m
            elif (m.keyer._map == lead.keyer._map
                    and m.keyer._next == lead.keyer._next):
                m.keyer = lead.keyer
        self._drop_step()

    def on_restore(self):
        """A restore wrote each member's map into its OWN keyer and gave
        each member new state tensors (``core/util/snapshot.py``):
        re-derive sharing from the restored maps and drop the step and its
        graphs (key capacities, slot layout and addresses may differ)."""
        with self._lock:
            for m in self.members:
                if m._own_keyer is not None:
                    m.keyer = m._own_keyer
            self.alias_keyers()

    def _drop_step(self):
        step, self._step = self._step, None
        close = getattr(step, "close", None)
        if close is not None:
            close()               # its program-cache ref
        self._sig = None
        if self._graph is not None:
            self._graph.drop()

    # --------------------------------------------------------- unwiring

    def release(self, member):
        """Hand one member back its own subscription (``parallel/mesh``
        routing takes over its step). A first or last member splices out
        in place; releasing a MIDDLE member dissolves the whole group (the
        survivors' fused slot could not keep the released member between
        them, and subscription-order delivery outranks keeping the
        fusion). A group left with fewer than two members dissolves."""
        with self._lock:
            if member not in self.members:
                return
            idx = self.members.index(member)
            if 0 < idx < len(self.members) - 1:
                self.dissolve()
                return
            self.members.remove(member)
            self._restore_member(member, after_group=idx > 0)
            self._clusters, self._cluster_of = [], []
            self._drop_step()
            if len(self.members) < 2:
                self.dissolve()
            else:
                self.captured = self.device.type == "cuda" and self.capturable()

    def dissolve(self):
        """Unfuse entirely: members resume their own receiver slots in
        subscription order."""
        with self._lock:
            recs = self.junction.receivers
            if self in recs:
                pos = recs.index(self)
                recs[pos:pos + 1] = list(self.members)
            for m in self.members:
                self._unalias(m)
            self.members = []
            self._clusters, self._cluster_of = [], []
            self._drop_step()
            self.captured = False
            if not _groups_of(self.junction):
                # last group on the stream: retire its metric surface
                tel = self.app_context.telemetry
                for g in ("group_size", "unique_programs", "captured"):
                    tel.remove_gauge(f"fanout.{self.stream_id}.{g}")

    def close(self):
        """Free the graphs and the staging (the app is shutting down)."""
        with self._lock:
            self._drop_step()
            self._staging = None
            if self._graph is not None:
                self._graph.close()

    def _restore_member(self, member, after_group: bool):
        self._unalias(member)
        recs = self.junction.receivers
        if self in recs:
            pos = recs.index(self)
            recs.insert(pos + (1 if after_group else 0), member)

    @staticmethod
    def _unalias(member):
        member._fanout_group = None
        own = member._own_keyer
        if own is not None and member.keyer is not own:
            # the shared keyer allocated this member's group ids since it
            # was aliased: the member's own keyer takes its map over
            shared = member.keyer
            own._map = dict(shared._map)
            own._next = shared._next
            own._lut = shared._lut.copy()
            member.keyer = own
        if member._state is not None:
            # identical-program dedup may have the member holding a
            # sibling's state object, which its own step would then update
            # a second time a batch
            member._state = clone_tree(member._state)

    # ---------------------------------------------------------- receiving

    def receive(self, events):
        batch = HostBatch.from_events(
            events, self.input_definition, self.dictionary,
            pool=pack_pool_of(self.app_context))
        self.process_batch(batch)

    def receive_batch(self, batch: HostBatch, junction=None):
        backfill_null_masks(batch, self.input_definition)
        self.process_batch(batch, junction=junction)

    def process_batch(self, batch: HostBatch, junction=None):
        if junction is None:
            junction = current_delivering_junction()
        with span("fanout.step", stream=self.stream_id, members=len(self.members)), \
                self._lock, contextlib.ExitStack() as stack:
            # member locks in subscription order (a snapshot takes them one
            # at a time: no cycle)
            for m in self.members:
                stack.enter_context(m._lock)
            self._process_locked(batch, junction=junction)

    # ----------------------------------------------------------- internals

    def _now(self) -> int:
        return int(self.app_context.timestamp_generator.current_time())

    def _prepare(self, batch: HostBatch):
        """Shared per-batch preparation: group-key columns (one per keyer
        object), each member's capacity and state, the fused input dict,
        and the fused step (rebuilt when the slot layout or any key
        capacity changed; a rebuild also re-derives the identical-program
        clusters). Returns ``(states, cols)``: ``states`` holds ONE state
        tree per cluster, ``cols`` the host (or device) columns."""
        cols = LazyColumns(batch.cols)   # keyer reads pull device columns once
        cap = dict.__getitem__(cols, VALID_KEY).shape[0]
        gk_cols: List[np.ndarray] = []
        slots: List[int] = []
        slot_of = {}
        for m in self.members:
            kid = id(m.keyer) if m.keyer is not None else 0
            s = slot_of.get(kid)
            if s is None:
                s = slot_of[kid] = len(gk_cols)
                gk_cols.append(np.zeros(cap, np.int32) if m.keyer is None
                               else m.keyer(cols))
            slots.append(s)
        for m in self.members:
            if m.keyer is not None:
                m._ensure_capacity()
            if m._state is None:
                m._state = m._init_state()
            prep = getattr(m, "prepare_cols", None)
            if prep is not None and prep(cols):
                # a join side grew its partition directory: the member's
                # state shapes changed under the same signature
                self._drop_step()
        fcols = dict(cols)       # the raw values: host arrays or device tensors
        for s, gk in enumerate(gk_cols):
            fcols[_FGK.format(s)] = gk
        if self._needs_rank:
            fcols[STR_RANK] = self.dictionary.rank_table()
        sig = (tuple(slots), tuple((m.selector_plan.num_keys, m._win_keys)
                                   for m in self.members))
        if self._step is None or sig != self._sig:
            self._build_step(tuple(slots), len(gk_cols))
            self._sig = sig
        return (tuple(self.members[c[0]]._state for c in self._clusters), fcols)

    def _build_step(self, slots: Tuple[int, ...], n_slots: int):
        """Build the group's single step. Members are first partitioned into
        identical-program clusters (equal ``program_signature()``, the same
        group-key slot, bit-equal current state): each cluster contributes
        ONE sub-computation whose outputs every cluster member shares, and
        distinct programs sit side by side in the same step."""
        t0 = time.perf_counter()
        close = getattr(self._step, "close", None)
        if close is not None:
            close()
        if self._graph is not None:
            self._graph.drop()
        members = self.members
        member_fns = [m.build_step_fn() for m in members]
        programs = [m.program_signature() for m in members]
        clusters: List[List[int]] = []
        for i, m in enumerate(members):
            for c in clusters:
                lead = c[0]
                if (slots[i] == slots[lead] and programs[i] is not None
                        and programs[i] == programs[lead]
                        and _states_equal(m._state, members[lead]._state)):
                    c.append(i)
                    break
            else:
                clusters.append([i])
        self._clusters = clusters
        self._cluster_of = [next(ci for ci, c in enumerate(clusters) if i in c)
                            for i in range(len(members))]
        # distinct leader state objects per cluster (a stale shared object
        # from a cluster that has since split would be stepped twice), and
        # each member holding its leader's: only the leader's step runs
        seen = set()
        for c in clusters:
            lead = members[c[0]]
            if id(lead._state) in seen:
                lead._state = clone_tree(lead._state)
            seen.add(id(lead._state))
            for i in c[1:]:
                members[i]._state = lead._state
        cluster_fns = [member_fns[c[0]] for c in clusters]
        gk_names = tuple(_FGK.format(s) for s in range(n_slots))
        gk_set = frozenset(gk_names)
        cluster_gk = [gk_names[slots[c[0]]] for c in clusters]

        def fused(states, cols, now):
            base = {k: v for k, v in cols.items() if k not in gk_set}
            outs, metas = [], []
            for ci, fn in enumerate(cluster_fns):
                mcols = dict(base)
                mcols[GK_KEY] = cols[cluster_gk[ci]]
                _st, out = fn(states[ci], mcols, now)
                metas.append(out.pop("__meta__"))
                outs.append(out)
            # a member's meta may carry a suffix (a join side's sequence):
            # zero-padded to the widest so the stack stays rectangular
            width = max(m.shape[0] for m in metas)
            metas = [m if m.shape[0] == width
                     else torch.cat([m, m.new_zeros(width - m.shape[0])])
                     for m in metas]
            return tuple(outs), torch.stack(metas)

        # the group's program: each cluster's member program, side by side
        # in cluster order, on its group-key slot; None (never shared)
        # when a member's cannot be rendered
        leads = [c[0] for c in clusters]
        program = None
        if all(programs[i] is not None for i in leads):
            program = (tuple(programs[i] for i in leads), tuple(map(tuple, clusters)),
                       tuple(slots), n_slots, self._needs_rank)
        self._step = self.app_context.telemetry.instrument_jit(
            fused, f"fanout.{self.stream_id}.step", family="fused_fanout",
            program=program,
            consts=([c for i in leads for c in members[i].program_consts()]
                    if program is not None else ()),
            capturable=self.capturable(), graph=self._graph if self.captured else None,
            build_ms=(time.perf_counter() - t0) * 1000.0,
            # the group counts one hit per member and batch itself
            count_hits=False)

    # the eager step's inputs, staged as a member stages its own: pinned
    # slots on the card, the host arrays as tensors on the CPU
    _to_device = QueryRuntime._to_device

    def _process_locked(self, batch: HostBatch, junction=None):
        from siddhi_tpu_torch.core.util.statistics import latency_t0, record_elapsed_ms

        members = self.members
        if not members:          # dissolved under a racing release
            return
        sm = self.app_context.statistics_manager
        tel = self.app_context.telemetry
        t0 = latency_t0(sm)
        # one journey a group batch: the shared dispatch and device stages
        # are recorded under every member's name at finish
        jr = journey.begin(batch) if journey.enabled() else None
        states, cols = self._prepare(batch)
        now = self._now()
        pump = self.app_context.completion_pump
        key = f"fanout.{self.stream_id}.step"
        if self.captured:
            outs, metas = self._step.replay(states, cols, now, pump.depth)
        else:
            outs, metas = self._step(states, self._to_device(cols), now)
        if jr is not None:
            jr.end_dispatch()
        for _m in members:       # member hit-counting: N query-batches
            tel.record_jit(key, hit=True)
        tel.count(f"fanout.{self.stream_id}.dispatches")
        if pump.depth > 1:
            # pipelined: the whole group batch rides in flight; per-member
            # emission and attribution run at drain (complete_entry). The
            # member list and cluster map are snapshotted: a release or a
            # rebuild between dispatch and drain must not re-map outputs
            meta, event = stage_meta(metas)
            for m in members:
                record_elapsed_ms(sm, m.name, t0)
            pump.submit(FusedCompletion(
                self, outs, meta, event, list(members), list(self._cluster_of),
                batch, junction=junction, journey=jr))
            return
        # ONE stacked meta pull for the whole group: the single
        # device-to-host round trip this layer exists to amortize
        if jr is not None:
            jr.pre_drain(journey.ready_of(metas))
            t_pull = time.perf_counter()
        metas_host = metas.cpu().numpy()
        if jr is not None:
            jr.drained((time.perf_counter() - t_pull) * 1000.0)
        tel.count(f"fanout.{self.stream_id}.meta_pulls")
        t_e = time.perf_counter() if jr is not None else None
        fatal = self._emit_members(list(members), list(self._cluster_of), outs,
                                   metas_host, batch, t0sm=t0)
        if jr is not None:
            jr.emit_ms = (time.perf_counter() - t_e) * 1000.0
            jr.finish(self.app_context, tuple(m.name for m in members))
        if fatal is not None:
            # surfaced AFTER every member emitted: the junction's
            # handle_error stores it so later sends re-raise, as an unfused
            # member's fatal would
            raise fatal

    def complete_entry(self, entry, metas_host) -> Optional[Exception]:
        """Drain-side tail of a pipelined group batch (``CompletionPump``):
        per-member emission and fault attribution over the snapshotted
        member list. Returns the fatal error (if any) for the pump's
        drain-then-raise instead of raising mid-round."""
        self.app_context.telemetry.count(f"fanout.{self.stream_id}.meta_pulls")
        with self._lock, contextlib.ExitStack() as stack:
            for m in entry.members:
                stack.enter_context(m._lock)
            jr = entry.journey
            t_e = time.perf_counter() if jr is not None else None
            fatal = self._emit_members(entry.members, entry.cluster_of, entry.outs,
                                       np.asarray(metas_host), entry.batch, t0sm=None)
            if jr is not None:
                jr.emit_ms = (time.perf_counter() - t_e) * 1000.0
                jr.finish(self.app_context, tuple(m.name for m in entry.members))
            return fatal

    def _emit_members(self, members, cluster_of, outs, metas_host, batch,
                      t0sm) -> Optional[Exception]:
        from siddhi_tpu_torch.core.util.statistics import record_elapsed_ms

        sm = self.app_context.statistics_manager
        fatal: Optional[Exception] = None
        for i, m in enumerate(members):
            row = metas_host[cluster_of[i]]
            overflow, notify, size = int(row[0]), int(row[1]), int(row[2])
            try:
                if row.shape[0] > 3:
                    # the member's meta suffix (zero-padded to the stack's
                    # width), decoded by the member's own instrument spec:
                    # its device.<q>.<slot> lanes, a join side's sequence
                    m.decode_meta_suffix(row)
                if overflow > 0:
                    raise FatalQueryError(
                        f"query '{m.name}': {m.overflow_knob_msg(overflow)} "
                        f"before creating the runtime")
                if t0sm is not None:   # the pipelined path recorded at dispatch
                    record_elapsed_ms(sm, m.name, t0sm)
                # an own LazyColumns per member over the shared tensors:
                # materialization and mutation must not leak across members
                m._emit(HostBatch(LazyColumns(outs[cluster_of[i]]), size=size))
                if notify >= 0 and m.scheduler is not None:
                    # defensive: eligible members carry no scheduler-driven
                    # window, so this timer (which would run the member's
                    # own unfused step) should never arm
                    m.scheduler.notify_at(notify, m._timer_cb)
            except Exception as e:  # noqa: BLE001 — per-member attribution
                fatal = self._route_member_error(m, batch, e, fatal)
        return fatal

    def _route_member_error(self, member, batch: HostBatch, e: Exception,
                            fatal: Optional[Exception]):
        """Per-member fault attribution: framework failures go to the fault
        stream under @OnError(action='stream'), naming ONLY the failing
        member, else they re-raise to the sender after the other members
        emitted; per-event processing errors take the junction's routing
        (route, or log and drop)."""
        from siddhi_tpu_torch.ops.expressions import CompileError

        j = self.junction
        if isinstance(e, (FatalQueryError, CompileError)):
            if j.on_error_action == "STREAM" and j.fault_junction is not None:
                j.route_fault_events(j.decode_events(batch), e)
                return fatal
            return fatal if fatal is not None else e
        try:
            j.handle_error(j.decode_events(batch), e)
        except Exception as raised:  # noqa: BLE001 — handle_error re-raises
            return fatal if fatal is not None else raised  # fatals only
        return fatal
