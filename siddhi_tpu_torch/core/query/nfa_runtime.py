"""Host side of pattern/sequence (NFA) queries.

Counterpart of ``siddhi_tpu/core/query/nfa_runtime.py`` (the reference's
pattern receivers + state runtime, ``query/input/stream/state/receiver/
*.java`` and ``StateStreamRuntime.java``): one runtime subscribes to every
junction the pattern consumes through ``StreamProxy`` receivers; each
arriving chunk runs that stream's NFA step (``ops/nfa.py``) and the
query's selector as torch ops on the app's device, with the state updated
in place.

The host decides each batch's engine: the two-step fast kernel (K4) or
the generic per-round engine (K5), from the batch's timestamps against
per-key high-water marks it keeps (``_host_hard_batch``); a hard batch
first gets the per-key expiry clears the generic engine would already
have made (``NFAStage.expire_to``). The generic engine's rounds are laid
out on the host from the partition keys it already holds
(``ops/nfa.round_rows``), so the loop costs no device read. A head batch
that is hard only because a key's rows span several instants may instead
run as K4 steps over runs of its rows, cut where a live match's `within`
deadline falls (``_head_runs``): an unpartitioned pattern is one key, and
K5 would take one round a row.

Absent (`not ... for t`) deadlines drive a scheduler loop: every step
reports the earliest pending deadline in its meta, the scheduler wakes the
runtime then, and ``process_timer`` runs the all-keys deadline sweep
(``NFAStage.apply_timer``) synchronously, after the query's in-flight
batches have emitted. A group by over capture columns runs its keyer on
the host between the NFA emission and the selector.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from siddhi_tpu_torch.core.event import Event, HostBatch, LazyColumns, pack_pool_of
from siddhi_tpu_torch.core.plan.selector_plan import GK_KEY, STR_RANK
from siddhi_tpu_torch.core.query.completion import QueryCompletion, stage_meta
from siddhi_tpu_torch.core.query.runtime import (
    QueryRuntime, backfill_null_masks, pack_meta)
from siddhi_tpu_torch.core.stream.junction import (
    FatalQueryError, Receiver, current_delivering_junction)
from siddhi_tpu_torch.observability import journey
from siddhi_tpu_torch.observability.instruments import Slot
from siddhi_tpu_torch.observability.tracing import span
from siddhi_tpu_torch.ops.expressions import PK_KEY, TS_KEY, TYPE_KEY, VALID_KEY, TorchXP
from siddhi_tpu_torch.ops.nfa import _T0_FAR, NFAStage, round_rows
from siddhi_tpu_torch.ops.windows import NOTIFY_KEY, OVERFLOW_KEY
from siddhi_tpu_torch.query_api.definitions import StreamDefinition

_SLOTS_MSG = "pattern match-slot capacity exceeded — raise app_context.nfa_slots"
_ROWS_KEY = "__nfa_rows__"   # host round layout, staged with the batch


class StreamProxy(Receiver):
    """Per-input-stream junction subscriber for one NFA query (the role of
    PatternSingle/SequenceSingleProcessStreamReceiver)."""

    def __init__(self, runtime: "NFAQueryRuntime", stream_id: str,
                 definition: StreamDefinition):
        self.runtime = runtime
        self.stream_id = stream_id
        self.definition = definition

    def receive(self, events: List[Event]):
        batch = HostBatch.from_events(
            events, self.definition, self.runtime.dictionary,
            pool=pack_pool_of(self.runtime.app_context))
        self.runtime.process_stream_batch(self.stream_id, batch)

    def receive_batch(self, batch: HostBatch, junction=None):
        backfill_null_masks(batch, self.definition)
        self.runtime.process_stream_batch(self.stream_id, batch,
                                          junction=junction)


class NFAQueryRuntime(QueryRuntime):
    def is_stateful(self) -> bool:
        # window and NFA state is always snapshot-relevant
        return True

    def __init__(self, name: str, app_context, stage: NFAStage,
                 input_defs: Dict[str, StreamDefinition],
                 stream_keyers: Dict[str, object], selector_plan, dictionary,
                 partition_ctx=None, out_keyer=None):
        super().__init__(
            name=name,
            app_context=app_context,
            input_definition=None,
            filters=[],
            window_stage=None,
            selector_plan=selector_plan,
            keyer=out_keyer,          # group-by over capture columns
            dictionary=dictionary,
            partition_ctx=partition_ctx,
        )
        self.stage = stage
        self.input_defs = input_defs
        self.stream_keyers = stream_keyers  # stream id -> partition keyer|None
        # host mirror of the PER-KEY event-time high-water marks (fast
        # two-step kernel dispatch — see _host_hard_batch; per key because
        # the generic engine's `_expire` only advances the clock of each
        # row's own key)
        self._nfa_hwm_arr: Optional[np.ndarray] = None

    # -------------------------------------------------------------- wiring

    def make_proxies(self) -> Dict[str, StreamProxy]:
        return {
            sid: StreamProxy(self, sid, self.input_defs[sid])
            for sid in self.stage.plan.stream_ids
        }

    # --------------------------------------------------------------- state

    def _init_state(self) -> dict:
        return {
            "sel": self.selector_plan.init_state(self.device),
            "nfa": self.stage.init_state(self._win_keys, self.device),
        }

    def _step_instrument_slots(self):
        """Every NFA step (a stream's and the timer sweep) appends the live
        partial-match slots (``_select``)."""
        return [Slot("nfa_runs")] if self._instruments_on() else []

    def _instrument_capacity(self, name):
        if name == "nfa_runs":
            return float(self._win_keys * self.stage.plan.slots)
        return super()._instrument_capacity(name)

    def arm_initial(self):
        """Arm key 0's head wait at app start (reference: absent pre-state
        processors schedule their first deadline when the runtime starts —
        ``AbsentStreamPreStateProcessor.java`` partitionCreated/start).

        Playback timelines have no wall origin, so the wait is anchored at
        the app clock's FIRST value instead, via a one-shot time-change
        listener — the first event on ANY stream starts the quiet window
        (AbsentPatternTestCase q7/q27)."""
        if self.stage.plan.arm_step() is None or self.partition_ctx is not None:
            return
        tsg = self.app_context.timestamp_generator
        if self.app_context.playback:
            tsg.once_first_time(lambda ts: self._arm_at(int(ts)))
            return
        self._arm_at(int(tsg.current_time()))

    def _arm_at(self, now: int):
        plan = self.stage.plan
        arm_j = plan.arm_step()
        st = plan.steps[arm_j]
        next_dl = None
        with self._device_scope(), self._lock:
            if self._state is None:
                self._state = self._init_state()
            nfa = self._state["nfa"]
            if bool(nfa["armed"][0]):
                return
            nfa["armed"][0] = True
            nfa["active"][0, 0] = True
            nfa["stepi"][0, 0] = arm_j
            # capture-less armed head: `within` anchors at the first
            # CAPTURE (T0 sentinel min()ed down there)
            capless = all(s.capture is None for s in st.sides)
            nfa["sts"][0, 0] = int(_T0_FAR) if capless else now
            if st.kind == "absent":
                nfa["adl"][0, 0] = now + st.wait_ms
                next_dl = now + st.wait_ms
            else:
                for side in st.sides:
                    if side.absent and side.wait_ms is not None:
                        nfa["adl" if side.bit == 1 else "adl2"][0, 0] = now + side.wait_ms
                        dl = now + side.wait_ms
                        next_dl = dl if next_dl is None else min(next_dl, dl)
        if next_dl is not None and self.scheduler is not None:
            self.scheduler.notify_at(int(next_dl), self._timer_cb)

    # ---------------------------------------------------------- step builds

    def build_stream_step_fn(self, stream_id: str, force_generic: bool = False):
        """(state, cols, now, rounds) -> (state, out) for one input stream:
        the NFA transition, then the selector stage unless a host group-by
        keyer has to run between them. ``force_generic`` runs the generic
        engine for a batch the host found hard for the fast kernel."""
        stage = self.stage
        xp = TorchXP(self.device)

        def step(state, cols, current_time, rounds=None):
            ctx = {"xp": xp, "current_time": current_time}
            cols = dict(cols)
            strrank = cols.pop(STR_RANK, None)   # selector-only side input
            if force_generic:
                new_nfa, out_cols = stage._apply_stream_generic(
                    stream_id, state["nfa"], cols, ctx, rounds)
            else:
                new_nfa, out_cols = stage.apply_stream(
                    stream_id, state["nfa"], cols, ctx, rounds)
            state["nfa"] = new_nfa
            if strrank is not None:
                out_cols[STR_RANK] = strrank
            return self._select(state, out_cols, ctx)

        return step

    def _instrumented_step(self, stream_id: Optional[str], generic: bool):
        """The stream step of ``stream_id`` (the timer step for None)
        through the step instrument (families ``nfa_step`` and
        ``nfa_timer``): compile events and costs. Eager, and never shared:
        the host picks K4 or K5 for each batch (``_host_hard_batch``) and
        lays K5's rounds out, so no one device program exists to share.
        The steps read the stage and the runtime at each call, so one
        instrument a (stream, engine) serves the query's life."""
        steps = self.__dict__.setdefault("_nfa_steps", {})
        inst = steps.get((stream_id, generic))
        if inst is None:
            tel = self.app_context.telemetry
            fn = (self.build_timer_step_fn() if stream_id is None
                  else self.build_stream_step_fn(stream_id, force_generic=generic))
            if self._route_layout is not None:
                # key-sharded across processes (parallel/mesh.shard_query_step):
                # this process's keys, the matches merged across processes
                from siddhi_tpu_torch.parallel.mesh import sharded_jit_for

                fn = sharded_jit_for(self, fn, timer=stream_id is None)
            if stream_id is None:
                inst = tel.instrument_jit(fn, f"nfa.{self.name}.timer", family="nfa_timer")
            else:
                inst = tel.instrument_jit(
                    fn, f"nfa.{self.name}.{stream_id}" + (".generic" if generic else ""),
                    family="nfa_step")
            steps[(stream_id, generic)] = inst
        return inst

    def build_timer_step_fn(self):
        stage = self.stage
        xp = TorchXP(self.device)

        def step(state, now):
            ctx = {"xp": xp, "current_time": now}
            state["nfa"], out_cols = stage.apply_timer(state["nfa"], now, ctx)
            return self._select(state, out_cols, ctx)

        return step

    def _select(self, state, out_cols, ctx):
        """The selector over the NFA emission, with the NFA's overflow and
        notify lanes packed into the step's meta, and with instruments on
        the ``nfa_runs`` lane behind them (the live match slots of the
        state the step holds). A group-by keyer over captures splits the
        pipeline: the emission goes out unselected and
        ``_host_keyed_select`` runs the selector after the host keys it."""
        out_cols = dict(out_cols)
        overflow = out_cols.pop("__overflow__")
        notify = out_cols.pop("__notify__")
        if out_cols[VALID_KEY].shape[0] == 0:
            # nothing can be emitted: the selector's state stays as it is
            out = pack_meta({VALID_KEY: out_cols[VALID_KEY],
                             OVERFLOW_KEY: overflow, NOTIFY_KEY: notify})
        elif self.keyer is not None:
            out_cols[OVERFLOW_KEY] = overflow
            out_cols[NOTIFY_KEY] = notify
            out = pack_meta(out_cols)
        else:
            plan = self.selector_plan
            if self._route_layout is not None and plan.ordered:
                # key-sharded across processes: the selection runs
                # unordered here, and its order by / limit once, on every
                # process's merged rows (parallel/mesh.sharded_jit_for)
                state["sel"], out = plan.unordered().apply(state["sel"], out_cols, ctx)
                out.update(plan.order_columns(out, out_cols))
            else:
                state["sel"], out = plan.apply(state["sel"], out_cols, ctx)
            sel_ov = out.get(OVERFLOW_KEY)
            out[OVERFLOW_KEY] = (overflow.to(torch.int64) if sel_ov is None
                                 else torch.maximum(overflow.to(torch.int64),
                                                    torch.as_tensor(sel_ov).to(torch.int64)))
            out[NOTIFY_KEY] = notify
            out = pack_meta(out)
        if self._step_instrument_slots():
            out["__meta__"] = torch.cat([
                out["__meta__"],
                state["nfa"]["active"].sum(dtype=torch.int64).reshape(1)])
        return state, out

    # ----------------------------------------------------------- processing

    def process_stream_batch(self, stream_id: str, batch: HostBatch,
                             junction=None):
        with span("query.step", query=self.name, stream=stream_id), \
                self._device_scope(), self._lock:
            j = junction or current_delivering_junction()
            self._cur_junction = j
            self._cur_fault_batch = batch if (
                j is not None and j.on_error_action == "STREAM"
                and j.fault_junction is not None) else None
            self._cur_journey = journey.begin(batch) if journey.enabled() else None
            lazy = LazyColumns(batch.cols)
            # the host checks read the batch's timestamps and keys: a
            # re-published batch held on the device comes over in one pull
            cols = {k: lazy[k] for k in list(dict.keys(lazy))}
            if self.partition_ctx is not None:
                keyer = self.stream_keyers.get(stream_id)
                if keyer is not None:
                    cols, pk = keyer.apply(cols)
                    cols = dict(cols)
                    cols[PK_KEY] = np.asarray(pk, np.int32)
                else:
                    cols[PK_KEY] = np.zeros(cols[VALID_KEY].shape[0], np.int32)
                cols[GK_KEY] = cols[PK_KEY]
                self._ensure_capacity()
                rl = self._route_layout
                if rl is not None:
                    # key-sharded across processes: this process's keys
                    # only, as local ids (global key g is local g // n on
                    # process g % n), before the host's checks read them
                    pk = np.asarray(cols[PK_KEY], np.int64)
                    cols[VALID_KEY] = np.asarray(cols[VALID_KEY]) & (pk % rl.n == rl.first)
                    cols[PK_KEY] = (pk // rl.n).astype(np.int32)
                    cols[GK_KEY] = cols[PK_KEY]
            else:
                cols[GK_KEY] = np.zeros(cols[VALID_KEY].shape[0], np.int32)
            if self._state is None:
                self._state = self._init_state()
            hard = self._host_hard_batch(stream_id, cols)
            runs = self._head_runs(cols) if hard == "spread" else None
            if runs is not None:
                notify = self._run_head_runs(stream_id, cols, runs)
            else:
                notify = self._run_batch(stream_id, cols, hard is not None)
        if notify is not None and self.scheduler is not None:
            self.scheduler.notify_at(notify, self._timer_cb)

    def _run_batch(self, stream_id: str, cols, force_generic: bool) -> Optional[int]:
        """One step over the batch: K4, or K5 with its rounds laid out
        (``force_generic``, or a plan K4 never takes). Returns its notify
        time."""
        generic = force_generic or (
            (self.stage._fast_side(stream_id) if self.stage.fast_enabled
             else None) is None)
        bounds = None
        if generic:
            valid = np.asarray(cols[VALID_KEY]) & (
                np.asarray(cols[TYPE_KEY]) == 0)
            pk = (np.clip(cols[PK_KEY], 0, self._win_keys - 1)
                  if PK_KEY in cols else np.zeros(valid.shape[0], np.int64))
            cols[_ROWS_KEY], bounds = round_rows(pk, valid)
        if self.selector_plan.needs_str_rank:
            cols[STR_RANK] = self.dictionary.rank_table()
        dev_cols = self._to_device(cols)
        rows = dev_cols.pop(_ROWS_KEY, None)
        step = self._instrumented_step(stream_id, force_generic)
        now = int(self.app_context.timestamp_generator.current_time())
        return self._run_nfa_step(lambda: step(
            self._state, dev_cols, now,
            None if bounds is None else (rows, bounds)))

    def _host_hard_batch(self, stream_id: str, cols) -> Optional[str]:
        """Host-side dispatch between the fast two-step kernel and the
        generic engine, decided from timestamps alone: None (K4 takes the
        batch), "order" or "spread" (hard), or "plan" (a plan K4 never
        takes). Hard conditions, each a conservative over-approximation:
        - "order", out-of-order timestamps (below the row's key's
          high-water mark, or decreasing in-batch): the fast kernel's lazy
          `within` expiry is exact only for monotone feeds;
        - "spread", head batches where one key's rows span several
          timestamps: a `within` deadline could cross inside the batch and
          re-order the free-slot list between same-key arming rows.
        When a batch is hard, the PER-KEY physical expiry clears the
        generic engine would already have made are applied first
        (`expire_to`)."""
        stage = self.stage
        side_kind = (stage._fast_side(stream_id)
                     if stage.fast_enabled else None)
        if side_kind is None:
            return "plan"
        if stage.plan.within is None:
            return None
        ts = np.asarray(cols[TS_KEY])
        valid = np.asarray(cols[VALID_KEY]) & (np.asarray(cols[TYPE_KEY]) == 0)
        tsv = ts[valid]
        if tsv.size == 0:
            return None
        K = self._win_keys
        arr = self._nfa_hwm_arr
        if arr is None or arr.shape[0] < K:
            grown = np.full(K, -(2 ** 62), np.int64)
            if arr is not None:
                grown[: arr.shape[0]] = arr
            self._nfa_hwm_arr = arr = grown
        pk = (np.asarray(cols[PK_KEY], np.int64) if PK_KEY in cols
              else np.zeros(ts.shape[0], np.int64))
        pkv = np.clip(pk[valid], 0, K - 1)
        hard = ("order" if bool(np.any(tsv < arr[pkv])) or bool(np.any(np.diff(tsv) < 0))
                else None)
        if hard is None and side_kind == "head" and tsv.min() != tsv.max():
            order = np.argsort(pkv, kind="stable")
            same = pkv[order][1:] == pkv[order][:-1]
            if np.any(same & (np.diff(tsv[order]) != 0)):
                hard = "spread"
        if hard is not None:
            self._state["nfa"] = stage.expire_to(self._state["nfa"], arr)
        if tsv.min() == tsv.max():
            # single-timestamp batch (the steady-state shape): duplicate
            # keys all write the same value
            arr[pkv] = np.maximum(arr[pkv], tsv[0])
        else:
            np.maximum.at(arr, pkv, tsv)
        return hard

    def _head_runs(self, cols) -> Optional[List[tuple]]:
        """A head batch, in order, whose keys' rows span several instants,
        as the row ranges ``[(lo, hi)]`` K4 takes exactly one after
        another: a run is cut before a row when a live match slot's
        `within` deadline falls between it and the valid row before it,
        so inside a run every row of a key sees the same free slots, and
        a head step arms the lowest ones in row order as K5 would. None
        when K5 is as cheap (no more rounds than runs), when the batch
        spans more than `within` (a slot armed in it could expire inside
        it), or when the query is split across processes (every process
        must take the same steps). One read of the slots' state."""
        from siddhi_tpu_torch.core.event import tensors_to_numpy

        w = self.stage.plan.within
        if self._route_layout is not None:
            return None
        valid = np.asarray(cols[VALID_KEY]) & (np.asarray(cols[TYPE_KEY]) == 0)
        idx = np.nonzero(valid)[0]
        tsv = np.asarray(cols[TS_KEY])[idx]
        if tsv[-1] - tsv[0] > w:
            return None
        pk = (np.clip(np.asarray(cols[PK_KEY], np.int64)[idx], 0, self._win_keys - 1)
              if PK_KEY in cols else np.zeros(idx.size, np.int64))
        rounds = int(np.bincount(pk).max())
        if rounds <= 2:
            return None
        nfa = self._state["nfa"]
        active, sts = tensors_to_numpy([nfa["active"], nfa["sts"]])
        deadlines = np.unique(sts[active] + w)
        # cut before valid row i when a deadline d has t[i-1] <= d < t[i]
        # (a slot live at t[i-1] is free at t[i])
        cut = (np.searchsorted(deadlines, tsv[1:], "left")
               > np.searchsorted(deadlines, tsv[:-1], "left"))
        starts = idx[1:][cut]
        if starts.size + 1 >= rounds:
            return None
        bounds = np.concatenate([[0], starts, [valid.shape[0]]])
        return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]

    def _run_head_runs(self, stream_id: str, cols, runs) -> Optional[int]:
        """K4's head step over each run of ``_head_runs`` in turn (the
        batch staged on the device once, each run a slice of it). A head
        step emits no match. Returns the last step's notify time."""
        if self.selector_plan.needs_str_rank:
            cols[STR_RANK] = self.dictionary.rank_table()
        dev_cols = self._to_device(cols)
        n = cols[VALID_KEY].shape[0]
        step = self._instrumented_step(stream_id, False)
        now = int(self.app_context.timestamp_generator.current_time())
        notify = None
        for lo, hi in runs:
            piece = {k: (v[lo:hi] if k != STR_RANK and v.dim() > 0 and v.shape[0] == n
                         else v) for k, v in dev_cols.items()}
            nt = self._run_nfa_step(lambda: step(self._state, piece, now, None))
            notify = nt if nt is not None else notify
        return notify

    def process_timer(self, ts: int):
        with self._device_scope(), self._lock:
            if self.app_context.stopped:
                return    # shutdown has dropped (or is dropping) the state
            # drain in-flight pipelined batches first: the deadline sweep
            # must observe a fully-emitted timeline (and runs sync itself)
            pump = self.app_context.completion_pump
            if pump.has_pending:
                pump.flush_owner(self)
            if self._state is None:
                self._state = self._init_state()
            step = self._instrumented_step(None, False)
            notify = self._run_nfa_step(lambda: step(self._state, int(ts)),
                                        allow_pipeline=False)
        if notify is not None and self.scheduler is not None:
            self.scheduler.notify_at(notify, self._timer_cb)

    def _run_nfa_step(self, run, allow_pipeline: bool = True) -> Optional[int]:
        """Run an NFA step; either hand its output to the pipeline or pull
        its packed meta (overflow, notify, count) in one copy, raise on a
        slot overflow and emit. With a group-by keyer over captures the
        emission is keyed on the host and the selector runs after."""
        from siddhi_tpu_torch.core.util.statistics import latency_t0, record_elapsed_ms

        sm = self.app_context.statistics_manager
        t0 = latency_t0(sm)
        jr, self._cur_journey = self._cur_journey, None
        self._state, out = run()
        out_host = LazyColumns(out)
        pump = self.app_context.completion_pump
        if allow_pipeline and pump.depth > 1 and self.keyer is None:
            # pipelined dispatch (completion.py): waitish plans are
            # eligible too, the pump hands __notify__ over at drain
            meta, event = stage_meta(dict.pop(out_host, "__meta__"))
            record_elapsed_ms(sm, self.name, t0)
            if jr is not None:
                jr.end_dispatch()
            pump.submit(QueryCompletion(
                self, out_host, meta, event, _SLOTS_MSG,
                junction=self._cur_junction, batch=self._cur_fault_batch,
                journey=jr))
            return None
        if jr is not None:
            jr.end_dispatch()
            jr.pre_drain(journey.ready_of(dict.__getitem__(out_host, "__meta__")))
            t_pull = time.perf_counter()
        meta = self._pull_meta(out_host)     # the one sync of the batch
        if jr is not None:
            jr.drained((time.perf_counter() - t_pull) * 1000.0)
        self.decode_meta_suffix(meta)
        overflow, notify, size = int(meta[0]), int(meta[1]), int(meta[2])
        if overflow > 0:
            raise FatalQueryError(
                f"query '{self.name}': {_SLOTS_MSG} before creating the runtime")
        record_elapsed_ms(sm, self.name, t0)
        t_e = time.perf_counter() if jr is not None else None
        if self.keyer is not None and size > 0:
            out_host, size = self._host_keyed_select(out_host)
        self._emit(HostBatch(out_host, size=size))
        if jr is not None:
            jr.emit_ms = (time.perf_counter() - t_e) * 1000.0
            jr.finish(self.app_context, (self.name,))
        return notify if notify >= 0 else None
