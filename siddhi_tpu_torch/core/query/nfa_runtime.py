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
(``ops/nfa.round_rows``), so the loop costs no device read.

Absent (`not ... for t`) deadlines drive a scheduler loop: every step
reports the earliest pending deadline in its meta, the scheduler wakes the
runtime then, and ``process_timer`` runs the all-keys deadline sweep
(``NFAStage.apply_timer``) synchronously, after the query's in-flight
batches have emitted. A group by over capture columns runs its keyer on
the host between the NFA emission and the selector.
"""

from __future__ import annotations

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
            if stream_id is None:
                inst = tel.instrument_jit(self.build_timer_step_fn(),
                                          f"nfa.{self.name}.timer", family="nfa_timer")
            else:
                inst = tel.instrument_jit(
                    self.build_stream_step_fn(stream_id, force_generic=generic),
                    f"nfa.{self.name}.{stream_id}" + (".generic" if generic else ""),
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
        notify lanes packed into the step's meta. A group-by keyer over
        captures splits the pipeline: the emission goes out unselected and
        ``_host_keyed_select`` runs the selector after the host keys it."""
        out_cols = dict(out_cols)
        overflow = out_cols.pop("__overflow__")
        notify = out_cols.pop("__notify__")
        if out_cols[VALID_KEY].shape[0] == 0:
            # nothing can be emitted: the selector's state stays as it is
            return state, pack_meta({VALID_KEY: out_cols[VALID_KEY],
                                     OVERFLOW_KEY: overflow, NOTIFY_KEY: notify})
        if self.keyer is not None:
            out_cols[OVERFLOW_KEY] = overflow
            out_cols[NOTIFY_KEY] = notify
            return state, pack_meta(out_cols)
        state["sel"], out = self.selector_plan.apply(state["sel"], out_cols, ctx)
        sel_ov = out.get(OVERFLOW_KEY)
        out[OVERFLOW_KEY] = (overflow.to(torch.int64) if sel_ov is None
                             else torch.maximum(overflow.to(torch.int64),
                                                torch.as_tensor(sel_ov).to(torch.int64)))
        out[NOTIFY_KEY] = notify
        return state, pack_meta(out)

    # ----------------------------------------------------------- processing

    def process_stream_batch(self, stream_id: str, batch: HostBatch,
                             junction=None):
        with self._device_scope(), self._lock:
            j = junction or current_delivering_junction()
            self._cur_junction = j
            self._cur_fault_batch = batch if (
                j is not None and j.on_error_action == "STREAM"
                and j.fault_junction is not None) else None
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
            else:
                cols[GK_KEY] = np.zeros(cols[VALID_KEY].shape[0], np.int32)
            if self._state is None:
                self._state = self._init_state()
            force_generic = self._host_hard_batch(stream_id, cols)
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
            notify = self._run_nfa_step(lambda: step(
                self._state, dev_cols, now,
                None if bounds is None else (rows, bounds)))
        if notify is not None and self.scheduler is not None:
            self.scheduler.notify_at(notify, self._timer_cb)

    def _host_hard_batch(self, stream_id: str, cols) -> bool:
        """Host-side dispatch between the fast two-step kernel and the
        generic engine, decided from timestamps alone. Hard conditions,
        each a conservative over-approximation:
        - out-of-order timestamps (below the row's key's high-water mark,
          or decreasing in-batch): the fast kernel's lazy `within` expiry
          is exact only for monotone feeds;
        - head batches where one key's rows span several timestamps: a
          `within` deadline could cross inside the batch and re-order the
          free-slot list between same-key arming rows.
        When a batch is hard, the PER-KEY physical expiry clears the
        generic engine would already have made are applied first
        (`expire_to`)."""
        stage = self.stage
        side_kind = (stage._fast_side(stream_id)
                     if stage.fast_enabled else None)
        if side_kind is None or stage.plan.within is None:
            return side_kind is None  # ineligible plans: generic always
        ts = np.asarray(cols[TS_KEY])
        valid = np.asarray(cols[VALID_KEY]) & (np.asarray(cols[TYPE_KEY]) == 0)
        tsv = ts[valid]
        if tsv.size == 0:
            return False
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
        hard = bool(np.any(tsv < arr[pkv])) or bool(np.any(np.diff(tsv) < 0))
        if not hard and side_kind == "head" and tsv.min() != tsv.max():
            order = np.argsort(pkv, kind="stable")
            same = pkv[order][1:] == pkv[order][:-1]
            hard = bool(np.any(same & (np.diff(tsv[order]) != 0)))
        if hard:
            self._state["nfa"] = stage.expire_to(self._state["nfa"], arr)
        if tsv.min() == tsv.max():
            # single-timestamp batch (the steady-state shape): duplicate
            # keys all write the same value
            arr[pkv] = np.maximum(arr[pkv], tsv[0])
        else:
            np.maximum.at(arr, pkv, tsv)
        return hard

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
        self._state, out = run()
        out_host = LazyColumns(out)
        pump = self.app_context.completion_pump
        if allow_pipeline and pump.depth > 1 and self.keyer is None:
            # pipelined dispatch (completion.py): waitish plans are
            # eligible too, the pump hands __notify__ over at drain
            meta, event = stage_meta(dict.pop(out_host, "__meta__"))
            record_elapsed_ms(sm, self.name, t0)
            pump.submit(QueryCompletion(
                self, out_host, meta, event, _SLOTS_MSG,
                junction=self._cur_junction, batch=self._cur_fault_batch))
            return None
        meta = out_host.pop("__meta__")     # the one sync of the batch
        overflow, notify, size = int(meta[0]), int(meta[1]), int(meta[2])
        if overflow > 0:
            raise FatalQueryError(
                f"query '{self.name}': {_SLOTS_MSG} before creating the runtime")
        record_elapsed_ms(sm, self.name, t0)
        if self.keyer is not None and size > 0:
            out_host, size = self._host_keyed_select(out_host)
        self._emit(HostBatch(out_host, size=size))
        return notify if notify >= 0 else None
