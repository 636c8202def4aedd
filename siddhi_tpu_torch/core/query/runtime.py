"""QueryRuntime: the host side of one compiled query.

Counterpart of ``siddhi_tpu/core/query/runtime.py``: the junction hands
the runtime a columnar batch, the runtime computes partition- and group-
key ids host-side (dense dictionaries), moves the columns to its device,
runs the step (stream-function transforms + filters + window + post-window
stages + selector as torch ops, with the state updated in place), pulls
the packed ``[overflow, notify, count]`` meta in one copy, raises
``FatalQueryError`` on a capacity overflow, hands a wanted wake time to
the app's scheduler and emits the output rows: columnar into the output
stream, or decoded to Events for a rate limiter and the query's
``QueryCallback``s (CURRENT rows as ``in_events``, EXPIRED as
``remove_events``), with ``uuid()`` columns filled on the host first.

Host windows (``ops/host_windows.py``: sort, frequent, session, cron,
expression, ...) run on the host before the device step, as in the
reference; the step then runs the selector. Inside a partition the
partition key is attached first, so a ``PartitionedHostWindow`` keeps one
instance per key. Rows of an inner ``#stream`` (or of a stream a
partition-mate produces) carry their pk column from the producing query
(``carried_pk``); ``reset_partition_keys`` restarts the state rows of
keys ``@purge`` retired. A timer fires
``process_timer``: a one-row TIMER chunk stamped at the timer's own time,
run synchronously after the query's in-flight batches have emitted. On a
timer thread the chunk enters the app's CUDA device first, so it runs on
the stream of the query's other steps.

A playback time window asks for a timer at its oldest row's time + t, so
once it expires it runs one TIMER step per millisecond of event time,
each a chunk of its own; a keyed session window asks for its earliest
key's last row + gap. Where nothing can tell those chunks' order from
one step's (no order by, limit or offset, no downstream query, no other
timer due in between), one TIMER step sweeps the whole chain up to the
clock: each row expires at its own chain time, and the output is split
back into one chunk per chain step (at each change of the stage's
``CHUNK_KEY`` lane, or of the timestamp), so callbacks and rate limiters
see the reference's chunks.

At ``pipeline_depth`` > 1 the step's output rides the app's
``CompletionPump`` (``core/query/completion.py``) instead: its meta
travels to pinned host memory behind a CUDA event, and the pump emits in
dispatch order once the meta has arrived, while the producer packs the
next batch. Depth 1 pulls the meta at once, as the reference does. On the
card, host columns reach the step through a ring of ``depth + 1`` pinned
staging slots per column with ``non_blocking`` copies, so packing the
next batch never waits behind the card's queue; a slot is written again
only once the event recorded after its last copy has completed.

A runtime may be a member of a fused fan-out group
(``core/query/fused_fanout.py``), which then takes its junction slot and
runs its step: ``_fanout_group`` names the group, ``_own_keyer`` keeps the
runtime's own ``GroupKeyer`` while it shares a sibling's,
``program_signature()`` tells identical programs apart and
``capturable()`` says whether its step may run inside a CUDA graph.

Every step goes through the step instrument
(``observability/telemetry.InstrumentedJit``, family ``query_step``; a
routed step ``device_routed``): compile events, cost capture and, for a
capturable step, the process-global program cache
(``core/util/program_cache.py``), whose witness adds the ids the app's
dictionary gave the query's string literals (``program_consts``). On the
card a capturable step runs as a CUDA graph replay (``captured``; the
gauge ``query.<q>.captured``): the cache entry's shared graph, or with
``siddhi_tpu.program_cache`` off the runtime's own (``core/query/
step_graph.py``). The step freezes the plan it was built from (the
selector's key capacity), so a step another app shares never follows this
runtime's later growth: a growth builds a new step.

Observability (ROADMAP A.10 a): each batch is a ``query.step`` span; with
batch journeys on it carries a ``Journey`` (its dispatch, device and emit
stages stamped here or at the pump's drain); with device instruments on
(the default) the step appends its lanes (``instrument_slots()``:
``win_fill``, ``groups``, the routed step's ``shard_rows`` and
``route_residual``) behind the meta's ``[overflow, notify, count]``,
computed inside the step and so inside its CUDA graph, and
``decode_meta_suffix`` decodes them into ``device.<q>.<slot>``
telemetry and ``_instr_last``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import enum
import logging
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.analysis.locks import make_lock
from siddhi_tpu_torch.core.event import (
    CURRENT, EXPIRED, TIMER, Event, HostBatch, LazyColumns, StringDictionary,
    encode_key_tuples, pack_pool_of)
from siddhi_tpu_torch.core.plan.selector_plan import GK_KEY, STR_RANK, SelectorPlan
from siddhi_tpu_torch.core.query.completion import QueryCompletion, stage_meta
from siddhi_tpu_torch.core.util.statistics import latency_t0, pytree_nbytes, record_elapsed_ms
from siddhi_tpu_torch.core.stream.junction import (
    FatalQueryError, Receiver, current_delivering_junction)
from siddhi_tpu_torch.observability import instruments, journey
from siddhi_tpu_torch.observability.instruments import Slot
from siddhi_tpu_torch.observability.tracing import span
from siddhi_tpu_torch.ops.expressions import (
    NUMPY_XP, PK_KEY, TS_KEY, TYPE_KEY, VALID_KEY, TorchXP)
from siddhi_tpu_torch.ops.types import TORCH_OF_NUMPY
from siddhi_tpu_torch.ops.windows import (
    CHUNK_KEY, NOTIFY_KEY, OVERFLOW_KEY, conform_cols)
from siddhi_tpu_torch.query_api.definitions import AttrType, StreamDefinition

_LOG = logging.getLogger(__name__)


class GroupKeyer:
    """Host-side group-by key dictionary: maps tuples of key-expression
    values to dense ids used to index ``[K, ...]`` state."""

    def __init__(self, fns: List[Tuple[Callable, AttrType]]):
        self._fns = fns
        self._map: Dict[tuple, int] = {}
        self._next = 0   # ids are NEVER reused
        # fast path: single string attribute -> LUT from dict id to key id
        self._single_string = len(fns) == 1 and fns[0][1] == AttrType.STRING
        self._lut = np.full(64, -1, np.int32)

    def _alloc(self, key: tuple) -> int:
        i = self._map.get(key)
        if i is None:
            i = self._map[key] = self._next
            self._next += 1
        return i

    def __len__(self):
        return self._next

    def __call__(self, cols: Dict[str, np.ndarray], pk: Optional[np.ndarray] = None) -> np.ndarray:
        """Group ids for a batch; when ``pk`` is given the dictionary key is
        (partition key, group-by values)."""
        ctx = {"xp": NUMPY_XP}
        valid = cols[VALID_KEY]
        B = valid.shape[0]
        gk = np.zeros(B, np.int32)
        if pk is None and self._single_string:
            v, m = self._fns[0][0](cols, ctx)
            # LUT slots are dict ids shifted +1: slot 0 is the NULL group
            ids = np.asarray(v, np.int64) + 1
            if m is not None:
                m = np.asarray(m, bool)
                if m.any():
                    ids = np.where(m, 0, ids)
            lut = self._lut
            if ids.size and ids.max() >= lut.shape[0]:
                top = int(ids.max()) + 1
                grown = np.full(max(top, 2 * lut.shape[0]), -1, np.int32)
                grown[: lut.shape[0]] = lut
                self._lut = lut = grown
            np.take(lut, ids, out=gk)
            missed = (gk < 0) & valid
            if missed.any():
                for sid in np.unique(ids[missed]):
                    if lut[sid] < 0:
                        lut[sid] = self._alloc((int(sid) - 1,))
                np.take(lut, ids, out=gk)
            gk[~valid] = 0
            return gk
        arrays = []
        if pk is not None:
            arrays.append(np.asarray(pk))
        for fn, _t in self._fns:
            v, m = fn(cols, ctx)
            arrays.append(np.broadcast_to(np.asarray(v), (B,)))
            # the null mask joins the key tuple: a null key forms its own group
            arrays.append(np.zeros(B, bool) if m is None
                          else np.broadcast_to(np.asarray(m, bool), (B,)))
        vidx = np.nonzero(valid)[0]
        if vidx.size == 0:
            return gk
        gk[vidx] = encode_key_tuples(arrays, vidx, self._alloc)
        return gk


class QueryRuntime(Receiver):
    # fan-out fusion (core/query/fused_fanout.py): the group this runtime is
    # a member of, and its own keyer while it shares a sibling's
    _fanout_group = None
    _own_keyer = None
    # the query's AST, set by the app at assembly (program_signature reads it)
    query_ast = None

    def __init__(self, name: str, app_context, input_definition: StreamDefinition,
                 filters: List[Callable], window_stage, selector_plan: SelectorPlan,
                 keyer: Optional[GroupKeyer], dictionary: StringDictionary,
                 partition_ctx=None, partition_keyer=None, transforms=None,
                 log_stages=None, post_pipeline=None, carried_pk: bool = False):
        self.name = name
        self.app_context = app_context
        self.device = app_context.device
        self.input_definition = input_definition
        self.filters = filters
        self.transforms = transforms or []   # ops/stream_functions stages
        self.log_stages = log_stages or []   # host #log() taps
        # ordered post-window stages: ("f", cond) | ("t", transform)
        self.post_pipeline = post_pipeline or []
        self.host_transforms = False   # transforms run on the host first
        self.host_window = None        # ops/host_windows stage, or None
        self.rate_limiter = None       # core/query/ratelimit, set by the app
        # a table action (core/query/output_callbacks.py) taking the
        # output Events in place of the output stream
        self.output_action: Optional[Callable] = None
        self.limiter_needs_pk = False  # partitioned limiter routes by pk
        self.limiter_needs_gk = False  # grouped limiter, key not projected
        self.scheduler = None          # the app's Scheduler, set by the app
        # the one timer target of this query: the scheduler dedupes
        # requests by (target, time), which a fresh bound method per
        # request would defeat (every batch before the first expiry would
        # start its own chain of timers)
        self._timer_cb = self.process_timer
        self.window_stage = window_stage
        self.selector_plan = selector_plan
        self.keyer = keyer
        self.dictionary = dictionary
        self.partition_ctx = partition_ctx
        self.partition_keyer = partition_keyer
        self.carried_pk = carried_pk   # input is an inner '#stream': rows carry pk
        self.attach_pk = False         # output feeds a partition-mate
        self._win_keys = 1
        if partition_ctx is not None:
            self._win_keys = max(_pow2(partition_ctx.num_keys()), 16)
        self.output_junction = None
        self._state: Optional[dict] = None
        self._step = None
        # on the card, a capturable step replays a CUDA graph: the program
        # cache entry's when the step shares one, else this private one
        # (core/query/step_graph.py); ``captured`` says which mode runs
        self._graph = None
        self.captured = False
        self._sel_step = None      # the split path's selector (_host_keyed_select)
        self._route_layout = None  # parallel.mesh.device_route_query_step
        # the mesh of parallel.mesh.shard_query_step or of a route: it bounds
        # this runtime's pulls under siddhi_tpu.cluster_step_timeout
        self._shard_mesh = None
        self.query_callbacks: List = []
        self._lock = make_lock("owner")  # per-query lock
        self._staging: Optional[StagingRing] = None
        # the delivering junction of the batch in process_batch, and its
        # input batch when that junction routes errors to a fault stream
        self._cur_junction = None
        self._cur_fault_batch = None
        # the batch journey of the batch in process (observability/journey.py)
        self._cur_journey = None
        # device instruments (observability/instruments.py): the last
        # drained lanes of each slot (the zero-pull scrape surface), the
        # host-known capacities, the gauges registered, the cached spec
        self._instr_last: Dict[str, np.ndarray] = {}
        self._instr_caps: Dict[str, float] = {}
        self._instr_gauged: set = set()
        self._instr_spec: Optional[List[Slot]] = None

    def is_stateful(self) -> bool:
        """Does this query hold state a snapshot must capture? A window,
        an aggregator or group by, or a rate limiter that is not
        pass-through (reference ``QueryRuntimeImpl.isStateful``)."""
        from siddhi_tpu_torch.core.query.ratelimit import PassThroughRateLimiter

        if self.window_stage is not None or self.host_window is not None:
            return True
        if self.selector_plan.contains_aggregator or self.selector_plan.group_by:
            return True
        rl = self.rate_limiter
        return rl is not None and not isinstance(rl, PassThroughRateLimiter)

    # ---------------------------------------------------------------- state

    @property
    def output_attrs(self) -> List[Tuple[str, AttrType]]:
        return self.selector_plan.output_attrs

    def _init_state(self) -> dict:
        state = {"sel": self.selector_plan.init_state(self.device)}
        if self.window_stage is not None:
            state["win"] = self.window_stage.init_state(self._win_keys, self.device)
        return state

    def _needed_sel_keys(self) -> int:
        if self.keyer is not None:
            return max(len(self.keyer), 1)
        if self.partition_ctx is not None:
            return self.partition_ctx.num_keys()
        return 1

    def _ensure_capacity(self):
        """Grow dense key capacity (pow2) when a key dictionary outgrows
        it; state rows are preserved (keyed buffers are laid out so a
        prefix copy keeps per-key alignment)."""
        if self._route_layout is not None:
            # routed runtimes hold PER-SHARD capacities: growth compares
            # the GLOBAL key population against n * localK
            from siddhi_tpu_torch.parallel.mesh import ensure_routed_capacity

            ensure_routed_capacity(self)
            return
        needed = self._needed_sel_keys()
        k = self.selector_plan.num_keys
        new_k = _pow2(needed, start=k) if needed > k else k
        new_w = self._win_keys
        if self.partition_ctx is not None:
            needed_w = self.partition_ctx.num_keys()
            if needed_w > self._win_keys:
                new_w = _pow2(needed_w, start=self._win_keys)
        if new_k == k and new_w == self._win_keys:
            return
        overload = getattr(self.app_context, "overload", None)
        if overload is not None and self._state is not None:
            # the device-memory budget gate (resilience/overload.py), before
            # anything is allocated or the step dropped: dense state scales
            # with the grown capacity, so the projection is the current
            # footprint (tensor metadata, no device read) times the growth
            from siddhi_tpu_torch.resilience.overload import ensure_memory_budget

            ratio = max(new_k / max(k, 1), new_w / max(self._win_keys, 1))
            ensure_memory_budget(
                self.app_context, f"query.{self.name}",
                int(pytree_nbytes(self._state) * ratio),
                what=f"query '{self.name}' key-capacity growth "
                     f"({k}->{new_k} keys)")
        self.selector_plan.num_keys = new_k
        self._win_keys = new_w
        old_state = self._state
        self._state = self._init_state()
        if old_state is not None:
            _copy_prefix_tree(self._state, old_state)
        self._step = None
        if self._shard_mesh is not None:
            # re-establish the key sharding on the grown state
            from siddhi_tpu_torch.parallel.mesh import shard_query_step

            shard_query_step(self, self._shard_mesh)
        if overload is not None:
            from siddhi_tpu_torch.resilience.overload import charge_memory

            charge_memory(self.app_context, f"query.{self.name}",
                          pytree_nbytes(self._state))

    def _make_step(self):
        if self._route_layout is not None:
            # a cleared step on a routed runtime must come back ROUTED
            from siddhi_tpu_torch.parallel.mesh import routed_step_for

            return routed_step_for(self)
        t0 = time.perf_counter()
        fn = self.build_step_fn()
        return self.instrument_step(fn, f"query.{self.name}.step", family="query_step",
                                    build_ms=(time.perf_counter() - t0) * 1000.0)

    def instrument_step(self, fn, key: str, family: str, cache_extra: str = "",
                        build_ms: float = 0.0):
        """This query's step through the step instrument
        (``observability/telemetry.InstrumentedJit``): compile events, cost
        capture and, for a capturable step, the program cache. On the card
        a capturable step replays a CUDA graph (``captured``; the gauge
        ``query.<q>.captured``)."""
        capturable = self.capturable()
        self.captured = capturable and self.device.type == "cuda"
        if self.captured:
            if self._graph is None:
                from siddhi_tpu_torch.core.query.step_graph import StepGraph

                self._graph = StepGraph(self.device)
            self._graph.drop()     # a new step is a new program
        tel = self.app_context.telemetry
        tel.gauge(f"query.{self.name}.captured",
                  lambda: 1.0 if self.captured else 0.0)
        return tel.instrument_jit(
            fn, key, family=family, cache_extra=cache_extra,
            program=self.program_signature(), consts=self.program_consts(),
            capturable=capturable, graph=self._graph if self.captured else None,
            build_ms=build_ms, packed=True)

    def drop_step(self):
        """Drop the step: its cache ref is released and its private graphs
        freed (the app is shutting down)."""
        step, self._step = self._step, None
        close = getattr(step, "close", None)
        if close is not None:
            close()
        if self._graph is not None:
            self._graph.close()
            self._graph = None
        self._sel_step = None

    def build_step_fn(self, split=None, key_split=None, unordered=False):
        """The (state, cols, now) -> (state, out) step of this query. The
        state tensors are updated in place and returned; ``cols`` are
        tensors on the state's device. For the key-sharded step across
        processes (``parallel/mesh.shard_query_step``): ``split(cols)``,
        when given, takes the rows the selector's state holds right before
        the selector (behind a global window); ``key_split`` (an
        ``ops/keyed_windows.KeySplit``) has a keyed window order its rows
        over the global key space; ``unordered`` leaves the selector's
        order by / limit / offset to the merged rows (the order-by input
        columns ride along: ``SelectorPlan.order_columns``)."""
        # a host window already ran the filters, transforms and post-window
        # stages on the host; host_transforms ran the transforms there
        host_pre = self.host_window is not None
        filters = [] if host_pre else list(self.filters)
        transforms = ([] if (host_pre or self.host_transforms)
                      else list(self.transforms))
        post_pipeline = [] if host_pre else list(self.post_pipeline)
        # the plan as it stands now: a capacity growth builds a new step,
        # and a step another app shares (core/util/program_cache.py) must
        # not follow this runtime's later growth
        plan = self.selector_plan
        sel = plan.unordered() if unordered else copy.copy(plan)
        win = self.window_stage
        if win is not None and hasattr(win, "_num_keys_ref"):
            win = copy.copy(win)
            win._num_keys_ref = lambda k=sel.num_keys: k
        xp = TorchXP(self.device)
        islots = self._step_instrument_slots()

        def step(state, cols, current_time):
            ctx = {"xp": xp, "current_time": current_time,
                   "horizon": self._timer_horizon, "key_split": key_split}
            cols = dict(cols)
            strrank = cols.pop(STR_RANK, None)   # window stages rebuild cols
            for t in transforms:
                cols = t.apply(cols, ctx)
            valid = cols[VALID_KEY]
            timer = cols[TYPE_KEY] == TIMER
            for f in filters:
                valid = valid & (f(cols, ctx) | timer)
            cols[VALID_KEY] = valid
            notify = overflow = chunk = None
            if win is not None:
                _st, cols = win.apply(state["win"], conform_cols(win, cols), ctx)
                cols = dict(cols)
                notify = cols.pop(NOTIFY_KEY, None)
                overflow = cols.pop(OVERFLOW_KEY, None)
                chunk = cols.pop(CHUNK_KEY, None)
                # post-window stages transform or mask the emitted rows
                ptimer = cols[TYPE_KEY] == TIMER
                for kind, obj in post_pipeline:
                    if kind == "t":
                        cols = obj.apply(cols, ctx)
                    else:
                        cols[VALID_KEY] = cols[VALID_KEY] & (
                            obj(cols, ctx) | ptimer)
                if key_split is not None and win.batch_mode:
                    cols = key_split.with_foreign_resets(cols)
            if split is not None:
                cols = split(dict(cols))
            lanes = (self._instrument_values(islots, state, cols, win, sel.num_keys)
                     if islots else None)
            if strrank is not None:
                cols[STR_RANK] = strrank
            _st, out = sel.apply(state["sel"], cols, ctx)
            if unordered:
                out.update(plan.order_columns(out, cols))
            if chunk is not None:
                # a swept TIMER step's chain step of each row (the selector
                # is row-aligned wherever a sweep runs)
                out[CHUNK_KEY] = chunk
            if notify is not None:
                out[NOTIFY_KEY] = notify
            if overflow is not None:
                sel_ov = out.get(OVERFLOW_KEY)
                overflow = torch.as_tensor(overflow).to(torch.int64)
                out[OVERFLOW_KEY] = overflow if sel_ov is None else torch.maximum(
                    overflow, torch.as_tensor(sel_ov).to(torch.int64))
            out = pack_meta(out)
            if lanes:
                # the instrument lanes ride behind [ov, notify, count],
                # decoded by the spec at drain (decode_meta_suffix)
                out["__meta__"] = torch.cat([out["__meta__"]] + lanes)
            return state, out

        return step

    # --------------------------------------------------- device instruments

    def _instruments_on(self) -> bool:
        """The per-app knob ``siddhi_tpu.profile_device_instruments``
        (default on; off keeps the meta layouts of the port before the
        instruments). Read when a step is built and at drain, so the
        layout and its decoder agree."""
        return instruments.app_instruments_on(self.app_context)

    def instrument_slots(self) -> List[Slot]:
        """The ordered spec of everything this runtime's meta carries
        behind ``[overflow, notify, count]``: the routed step's slots first
        (``route_overflow`` and ``shard_rows`` whatever the knob, then
        ``route_residual``), then the inner step's
        (``_step_instrument_slots``). Cached; a route install or an engine
        attach clears ``_instr_spec``."""
        if self._instr_spec is not None:
            return self._instr_spec
        spec: List[Slot] = []
        rl = self._route_layout
        if rl is not None:
            spec.append(Slot("route_overflow", kind="check"))
            spec.append(Slot("shard_rows", width=rl.n))
            if self._instruments_on():
                spec.append(Slot("route_residual"))
        spec.extend(self._step_instrument_slots())
        self._instr_spec = spec
        return spec

    def _step_instrument_slots(self) -> List[Slot]:
        """The slots the inner (per-shard) step appends; the join and NFA
        runtimes declare their own."""
        if not self._instruments_on():
            return []
        slots: List[Slot] = []
        if self.window_stage is not None and hasattr(self.window_stage, "live_fill"):
            slots.append(Slot("win_fill", reduce="max"))
        if self.keyer is not None or self.partition_ctx is not None:
            slots.append(Slot("groups"))
        return slots

    def _instrument_values(self, slots: List[Slot], state, cols, win,
                           num_keys: int) -> List[torch.Tensor]:
        """The data lanes, as torch ops inside the step (no host read: on
        the card they run inside the step's CUDA graph) from the state and
        columns the step holds: ``win_fill`` the window's live rows (the
        hottest key's for a keyed ring), ``groups`` the distinct group keys
        among the valid rows the selector takes (a scatter into ``[K + 1]``
        bools and a sum)."""
        vals = []
        for slot in slots:
            if slot.name == "win_fill":
                vals.append(win.live_fill(state["win"]).to(torch.int64).reshape(1))
            elif slot.name == "groups":
                valid = cols[VALID_KEY]
                gk = torch.clamp(torch.as_tensor(cols[GK_KEY]).to(torch.int64),
                                 0, num_keys - 1)
                idx = torch.where(valid, gk, num_keys)
                # index_fill_ takes its value as a scalar: no host tensor
                # enters a captured graph
                seen = torch.zeros(num_keys + 1, dtype=torch.bool,
                                   device=valid.device).index_fill_(0, idx, True)
                vals.append(seen[:num_keys].sum(dtype=torch.int64).reshape(1))
        return vals

    def _instrument_capacity(self, name: str) -> Optional[float]:
        """The host-known denominator of one data slot (the report quotes
        saturation against it); None for a slot without one."""
        rl = self._route_layout
        if name == "win_fill":
            return getattr(self.window_stage, "ring_capacity", None)
        if name == "groups":
            k = self.selector_plan.num_keys
            return float(k * rl.n) if rl is not None else float(k)
        if name in ("shard_rows", "route_residual"):
            return float(rl.n * rl.quota) if rl is not None else None
        return None

    def decode_meta_suffix(self, meta) -> None:
        """Decode the meta behind its 3-lane prefix by the spec (the
        synchronous tail, the pump's drain and each fused member share
        it): data slots feed ``device.<query>.<slot>`` telemetry and the
        zero-pull ``_instr_last`` cache, then the check slots run (the
        route overflow raises, the join sequence is verified). Data lands
        first, so a fatal overflow still leaves the lanes that show it."""
        spec = self.instrument_slots()
        meta = np.asarray(meta)
        if not spec or meta.shape[0] <= 3:
            return
        ins_on = self._instruments_on()
        checks = []
        i = 3
        for slot in spec:
            if i + slot.width > meta.shape[0]:
                # a meta shorter than its spec: the step and the spec
                # drifted apart, and the checks left are not decoded
                if "decode_short" not in self._instr_gauged:
                    self._instr_gauged.add("decode_short")
                    _LOG.error("query '%s': meta suffix (%d lanes) shorter than "
                               "the instrument spec %s", self.name,
                               meta.shape[0] - 3, [s.name for s in spec])
                self.app_context.telemetry.count("device.decode_short")
                break
            vals = np.asarray(meta[i:i + slot.width], np.int64)
            i += slot.width
            if slot.kind == "check":
                checks.append((slot, vals))
            else:
                self._record_instrument(slot, vals, telemetry=ins_on)
        for slot, vals in checks:
            self._consume_check_slot(slot.name, vals)

    def _record_instrument(self, slot: Slot, vals, telemetry: bool) -> None:
        """One data slot's drained lanes: the zero-pull cache, and with
        instruments on its telemetry (``instruments.record``)."""
        self._instr_last[slot.name] = vals
        if telemetry:
            instruments.record(self, slot, vals,
                               capacity=self._instrument_capacity(slot.name))

    def _consume_check_slot(self, name: str, vals) -> None:
        """The structural slots' consumers; the join runtime adds
        ``seq``."""
        if name == "route_overflow":
            self._route_layout.route_overflow_rows += int(vals[0])
            if int(vals[0]) > 0:
                raise FatalQueryError(f"query '{self.name}': {self.route_overflow_msg()}")

    # ------------------------------------------------------- fan-out fusion

    def program_signature(self) -> Optional[tuple]:
        """A conservative, hashable account of everything that decides
        what this query's step computes: the query's AST without its name
        and its output target, the input definition, the planner knobs the
        plan read (precision, fusion, capacities, each value table's H),
        the stage the plan chose, the key capacities, the selector's
        output names and types, the device, and the instrument spec (the
        meta's layout: an app with device instruments off never shares a
        step, or a fused cluster, with one that has them on). Two members
        of a fused group with equal signatures (and bit-equal states) run
        as one
        computation: the port's stand-in for the reference's jaxpr
        equality (``siddhi_tpu/core/query/fused_fanout.py:85-131``). None
        when any part cannot be rendered; None never clusters."""
        q = self.query_ast
        if q is None:
            return None
        out = q.output_stream
        try:
            ast = _render(dataclasses.replace(
                q, annotations=[a for a in q.annotations if a.name.lower() != "info"],
                output_stream=(None if out is None
                               else dataclasses.replace(out, target_id=""))))
            defn = _render(self.input_definition)
        except _Unrenderable:
            return None
        ctx, sp = self.app_context, self.selector_plan
        return (ast, defn,
                (ctx.precision, ctx.enable_fusion, ctx.window_capacity,
                 ctx.distinct_values_capacity),
                tuple((spec.kind, spec.distinct_capacity) for spec in sp.specs),
                type(self.window_stage).__name__, sp.num_keys, self._win_keys,
                tuple((n, t.name) for n, t in sp.output_attrs), str(self.device),
                tuple((s.name, s.width, s.kind) for s in self.instrument_slots()))

    def program_consts(self) -> tuple:
        """The constants this query's step took from app state at plan
        time: the id the app's string dictionary gave each string literal
        of the query (``ops/expressions.compile_expr`` compiles ``sym ==
        'IBM'`` to a comparison with that id). Two apps' dictionaries may
        give one literal different ids, so the program cache's witness
        compares these bit for bit. A literal the plan did not encode (a
        cast's type name) has no id and enters as -1: it is looked up,
        not encoded, so the dictionary gains nothing."""
        if self.query_ast is None:
            return ()
        ids = (self.dictionary.lookup(v) for v in _string_literals(self.query_ast))
        return tuple(np.int32(-1 if i is None else i) for i in ids)

    def capturable(self) -> bool:
        """Whether this query's step may run inside a CUDA graph: every
        stage of the step declares ``capturable`` (no host read, the clock
        taken as a tensor), as do its aggregators and every function its
        expressions call (``ops/expressions.capturable``). Host stages never
        are; inside a partition the keyed window declares its own (the
        partition and group keys are host-computed input columns)."""
        from siddhi_tpu_torch.ops import aggregators, distinct, expressions

        if (self.host_window is not None or self.host_transforms
                or self.log_stages or self.query_ast is None):
            return False
        if self._route_layout is not None and self._route_layout.P > 1:
            return False     # the collectives of a process group size rows on the host
        stages = list(self.transforms) + [obj for kind, obj in self.post_pipeline
                                          if kind == "t"]
        if self.window_stage is not None:
            stages.append(self.window_stage)
        stages.append(self.selector_plan)
        if not all(getattr(st, "capturable", False) for st in stages):
            return False
        kinds = {spec.kind for spec in self.selector_plan.specs}
        if kinds and not aggregators.capturable:
            return False
        if kinds & set(aggregators.DISTINCT_KINDS) and not distinct.capturable:
            return False
        q = self.query_ast
        return expressions.capturable(
            [q.input_stream, q.selector],
            aggregators=frozenset(aggregators.supported_aggregators()))

    # ----------------------------------------------------------- processing

    def receive(self, events: List[Event]):
        batch = HostBatch.from_events(
            events, self.input_definition, self.dictionary,
            pool=pack_pool_of(self.app_context))
        if self.carried_pk:
            pk = np.zeros(batch.capacity, np.int32)
            pk[:len(events)] = [e.pk or 0 for e in events]
            batch.cols[PK_KEY] = pk
        self.process_batch(batch)

    def receive_batch(self, batch: HostBatch, junction=None):
        if self.carried_pk and PK_KEY not in batch.cols:
            batch.cols[PK_KEY] = np.zeros(batch.capacity, np.int32)
        backfill_null_masks(batch, self.input_definition)
        self.process_batch(batch, junction=junction)

    _now_override = None   # a timer chunk runs at its scheduled time
    _timer_horizon = None  # the clock a TIMER step sweeps its chain to

    def _now(self) -> int:
        """The clock of window expiry and stamping: a TIMER chunk's own
        time while one runs (the playback clock has already moved past
        queued timers), else the app clock."""
        if self._now_override is not None:
            return self._now_override
        return int(self.app_context.timestamp_generator.current_time())

    def process_timer(self, ts: int):
        """Run a one-row TIMER chunk stamped at ``ts`` (reference
        ``Scheduler.sendTimerEvents`` + ``EntryValveProcessor``)."""
        batch = HostBatch.from_events(
            [Event(timestamp=int(ts),
                   data=[_zero_value(a.type) for a in self.input_definition.attributes])],
            self.input_definition, self.dictionary)
        batch.cols[TYPE_KEY][...] = TIMER
        # the lock comes before the override: an event batch on another
        # thread must never see the timer's time as its clock
        with self._device_scope(), self._lock:
            if self.app_context.stopped:
                return    # shutdown has dropped (or is dropping) the state
            # batches in flight were dispatched before this timer fired:
            # they emit first, and the timer chunk itself runs
            # synchronously (_now_override gates the pipeline)
            pump = self.app_context.completion_pump
            if pump.has_pending:
                pump.flush_owner(self)
            self._now_override = int(ts)
            self._timer_horizon = self._sweep_horizon(int(ts))
            try:
                self.process_batch(batch)
            finally:
                self._now_override = None
                self._timer_horizon = None

    def _sweep_horizon(self, ts: int) -> Optional[int]:
        """How far a TIMER step at ``ts`` may sweep its window's chain of
        timers (a time window's, keyed or not, or a keyed session's): to
        the playback clock, but short of any other pending timer (a rate
        limiter's tick, another query's window, a purge), and only where
        one chunk per chain step can be rebuilt from one step's output and
        nothing downstream would see the steps interleave otherwise.
        None: the step runs at ``ts`` alone."""
        from siddhi_tpu_torch.ops.keyed_windows import (
            KeyedSessionWindowStage, KeyedTimeWindowStage)
        from siddhi_tpu_torch.ops.windows import TimeWindowStage

        win, sp = self.window_stage, self.selector_plan
        sweepable = (isinstance(win, (TimeWindowStage, KeyedTimeWindowStage))
                     and not win.external) or isinstance(
                         win, KeyedSessionWindowStage)
        if not (self.app_context.playback and self.scheduler is not None
                and sweepable
                and not (sp.order_by or sp.batch_mode)
                and sp.limit is None and sp.offset is None):
            return None
        from siddhi_tpu_torch.core.query.fused_fanout import FusedFanoutRuntime

        j = self.output_junction
        if j is not None and (self.attach_pk or any(
                isinstance(r, (QueryRuntime, FusedFanoutRuntime))
                for r in j.receivers)):
            return None
        horizon = int(self.app_context.timestamp_generator.current_time())
        other = self.scheduler.next_due_except(self._timer_cb)
        if other is not None:
            horizon = min(horizon, other - 1)
        return horizon if horizon > ts else None

    def _device_scope(self):
        """The app's CUDA device on this thread (a timer thread starts on
        device 0), so a timer's step runs on the stream of the query's
        other steps; nothing off the card."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _run_log_taps(self, batch: HostBatch):
        """The host side of ``#log()`` taps: replay each tap's slice of the
        pre-window pipeline with numpy and log the rows flowing at its
        position in the handler chain (LogStreamProcessor.java:219-277)."""
        base_valid = np.asarray(batch.cols[VALID_KEY]) & (
            np.asarray(batch.cols[TYPE_KEY]) == CURRENT)
        if not base_valid.any():
            return
        ctx = {"xp": NUMPY_XP, "current_time": self._now()}
        # replay only the transform prefix some tap reads
        depth = min(max(t.n_transforms for t in self.log_stages),
                    len(self.transforms))
        stages = [batch.cols]
        for t in self.transforms[:depth]:
            stages.append(t.apply(stages[-1], ctx))
        for tap in self.log_stages:
            cols = stages[min(tap.n_transforms, len(stages) - 1)]
            valid = np.asarray(cols[VALID_KEY]) & (
                np.asarray(cols[TYPE_KEY]) == CURRENT)
            for f in self.filters[: tap.n_filters]:
                valid = valid & np.asarray(f(cols, ctx))
            idx = np.nonzero(valid)[0]
            if idx.size == 0:
                continue
            attrs = list(self.input_definition.attributes)
            for t in self.transforms[: tap.n_transforms]:
                attrs.extend(t.out_attrs)
            rows, timestamps = [], []
            ts_col = cols[TS_KEY]
            for i in idx:
                row = []
                for a in attrs:
                    mcol = cols.get(a.name + "?")
                    if mcol is not None and bool(mcol[i]):
                        row.append(None)
                    elif a.type == AttrType.STRING:
                        row.append(self.dictionary.decode(int(cols[a.name][i])))
                    else:
                        row.append(cols[a.name][i].item())
                rows.append(tuple(row))
                timestamps.append(int(ts_col[i]))
            tap.emit(rows, timestamps)

    def _host_pre(self, batch: HostBatch):
        """Host stages ahead of the device step: a host window (with the
        filters, transforms and post-window stages around it, as numpy)
        or the host transforms. Returns (batch, the host window's wake
        time or None)."""
        if self.host_window is not None:
            now_h = self._now()
            ctx = {"xp": NUMPY_XP, "current_time": now_h}
            cols = batch.cols
            for t in self.transforms:
                cols = t.apply(cols, ctx)
            cols = dict(cols)
            valid = np.asarray(cols[VALID_KEY])
            timer = np.asarray(cols[TYPE_KEY]) == TIMER
            for f in self.filters:
                valid = valid & (np.asarray(f(cols, ctx)) | timer)
            cols[VALID_KEY] = valid
            batch, notify = self.host_window.process(HostBatch(cols), now_h)
            if self.post_pipeline:
                cols = dict(batch.cols)
                ptimer = cols[TYPE_KEY] == TIMER
                for kind, obj in self.post_pipeline:
                    if kind == "t":
                        cols = obj.apply(cols, ctx)
                    else:
                        cols[VALID_KEY] = cols[VALID_KEY] & (
                            np.asarray(obj(cols, ctx)) | ptimer)
                batch = HostBatch(cols)
            return batch, notify
        if self.host_transforms:
            cols = dict(batch.cols)
            ctx = {"xp": NUMPY_XP, "current_time": self._now()}
            for t in self.transforms:
                cols = t.apply(cols, ctx)
            return HostBatch(cols), None
        return batch, None

    def process_batch(self, batch: HostBatch, junction=None):
        notify = None
        with span("query.step", query=self.name), self._lock:
            # Event-path deliveries carry no junction parameter: the
            # delivery loop's thread-local names it, so pipelined
            # completions keep their error routing and latency feedback
            j = junction or current_delivering_junction()
            self._cur_junction = j
            self._cur_fault_batch = batch if (
                j is not None and j.on_error_action == "STREAM"
                and j.fault_junction is not None) else None
            # the batch journey: the pack stamp forked, the dispatch stage
            # (host prep and the step's launch) open; _finish_device_batch
            # takes it (a routed batch split in pieces: the first piece)
            self._cur_journey = journey.begin(batch) if journey.enabled() else None
            if self.log_stages:
                self._run_log_taps(batch)
            partitioned = self.partition_ctx is not None
            pk_done = partitioned and self.host_window is not None
            if pk_done:
                # per-key host stages route rows by the pk column, so the
                # partition key is attached before the window runs (and
                # rides through its emitted rows)
                batch = HostBatch(self._attach_pk(LazyColumns(batch.cols)))
            batch, notify = self._host_pre(batch)
            # a re-published batch may hold device tensors: the keyers'
            # reads pull them to the host in one copy, a step without
            # keyers takes them as they are
            cols = LazyColumns(batch.cols)
            pk = None
            if partitioned:
                cols = dict(cols) if pk_done else self._attach_pk(cols)
                pk = cols.get(PK_KEY)
                if pk is None:
                    pk = np.zeros(cols[VALID_KEY].shape[0], np.int32)
                cols[PK_KEY] = np.asarray(pk, np.int32)
            if self.keyer is not None:
                cols[GK_KEY] = self.keyer(cols, pk=pk if partitioned else None)
            elif partitioned:
                cols[GK_KEY] = cols[PK_KEY]
            else:
                cols[GK_KEY] = np.zeros(cols[VALID_KEY].shape[0], np.int32)
            if partitioned or self.keyer is not None:
                self._ensure_capacity()
            if self._state is None:
                self._state = self._init_state()
            if self._step is None:
                self._step = self._make_step()
            if self._route_layout is not None:
                # routed dispatch: pad/precheck host-side (splitting
                # oversized batches instead of overflowing) and run each
                # piece through the routed step in order
                from siddhi_tpu_torch.parallel.mesh import (
                    HOST_NOTIFY_KEY, prepare_routed_batches)

                if self._route_layout.split and self.host_window is not None:
                    # key-sharded across processes: this process's host
                    # window instances' wake time merges with every other
                    # process's in the step's meta
                    cols[HOST_NOTIFY_KEY] = np.asarray(
                        -1 if notify is None else notify, np.int64)

                for piece in prepare_routed_batches(self, cols):
                    self._route_layout.dispatches += 1
                    notify = _min_notify(
                        notify, self._finish_device_batch(self._step, piece))
            else:
                notify = _min_notify(
                    notify, self._finish_device_batch(self._step, cols))
        if notify is not None and self.scheduler is not None:
            self.scheduler.notify_at(notify, self._timer_cb)

    def _attach_pk(self, cols) -> dict:
        """The batch's columns with its partition-key column: computed by
        the partition keyer (a range keyer expands the batch), or carried
        by an inner stream's rows (one host read of the whole batch)."""
        if self.carried_pk:
            pk = cols.get(PK_KEY)    # a LazyColumns read pulls the batch once
            cols = dict(cols)
            cols[PK_KEY] = (np.zeros(cols[VALID_KEY].shape[0], np.int32)
                            if pk is None else np.asarray(pk, np.int32))
            return cols
        cols, pk = self.partition_keyer.apply(cols)
        cols = dict(cols)
        cols[PK_KEY] = np.asarray(pk, np.int32)
        return cols

    def reset_partition_keys(self, ids):
        """Restart the state rows of partition keys ``@purge`` retired, so
        their ids can be reused by new keys (reference PartitionRuntimeImpl
        purge): the window's rows, a pattern's match slots, the
        selector's rows (reset to the aggregators' INIT values) or, with a
        group by, the (pk, group) dictionary entries, the per-key rate
        limiters and host windows.
        Runs on the purge job's thread: it enters the app's device and the
        query lock, and drains the query's in-flight batches first."""
        if self.rate_limiter is not None and hasattr(self.rate_limiter, "reset_keys"):
            # per-key limiter instances of retired keys must not leak
            # their counters or pending rows into a recycled pk
            self.rate_limiter.reset_keys(ids)
        with self._device_scope(), self._lock:
            pump = self.app_context.completion_pump
            if pump.has_pending:
                pump.flush_owner(self)
            if self.host_window is not None and hasattr(self.host_window, "reset_keys"):
                self.host_window.reset_keys(ids)
            if self._state is None:
                return
            rl = self._route_layout
            ids_all = ids_np = np.asarray(ids, np.int64)
            if rl is not None:
                # routed state is shard-major: global pk id g lives at row
                # (g % n - first) * local + g // n of each keyed buffer of
                # the process that owns shard g % n
                ids_np = ids_np[(ids_np % rl.n >= rl.first)
                                & (ids_np % rl.n < rl.first + rl.L)]
                win_idx = (ids_np % rl.n - rl.first) * rl.local_win + ids_np // rl.n
            else:
                win_idx = ids_np
            dev = self.device
            state = self._state
            if "win" in state and hasattr(self.window_stage, "reset_keys"):
                self.window_stage.reset_keys(
                    state["win"], torch.as_tensor(win_idx, device=dev))
            if "nfa" in state:
                # a pattern's retired keys hold no pending match, and their
                # start states arm afresh
                idx = torch.as_tensor(win_idx, device=dev)
                for k in ("active", "consumed", "armed"):
                    state["nfa"][k].index_fill_(0, idx, False)
            if self.keyer is None:
                # gk == pk: selector rows are addressed by partition id. Rows
                # reset to the aggregator INIT values, gathered from a fresh
                # state; the key axis is the first axis sized num_keys
                K = self.selector_plan.num_keys
                init = self.selector_plan.init_state(dev)
                sel_idx = init_idx = ids_np
                if rl is not None:
                    # init rows are identical per key: gather at the local id
                    K = K * rl.L
                    sel_idx = (ids_np % rl.n - rl.first) * rl.localK + ids_np // rl.n
                    init_idx = ids_np // rl.n
                _reset_key_rows(state["sel"], init, K,
                                torch.as_tensor(sel_idx, device=dev),
                                torch.as_tensor(init_idx, device=dev))
            else:
                # composite (pk, group) keys: drop the purged pks' entries so
                # a reused id cannot alias old groups (their gk rows become
                # unreachable; gk ids are never reused)
                dead = set(int(i) for i in ids_all)   # the keyer is every process's
                self.keyer._map = {k: v for k, v in self.keyer._map.items()
                                   if int(k[0]) not in dead}
                self.keyer._lut = np.full(64, -1, np.int32)

    def route_overflow_msg(self) -> str:
        rl = self._route_layout
        rps = rl.rows_per_shard if rl is not None else 0
        return (f"shard exchange overflow — more rows bound for one shard "
                f"pair than its quota; raise rows_per_shard={rps} "
                f"(device_route_query_step) or split the batch")

    def _to_device(self, cols: Dict) -> Dict[str, torch.Tensor]:
        if self.device.type == "cuda":
            if self._staging is None:
                self._staging = StagingRing(self.device)
            return self._staging.put(cols, self.app_context.completion_pump.depth)
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(v)))
                for k, v in dict.items(cols)}

    def overflow_knob_msg(self, code: Optional[int] = None) -> str:
        """The capacity-overflow message naming its knobs: a time or batch
        window's ring (``siddhi_tpu.window_capacity``) or a
        distinctCount/unionSet value table. ``code`` (the meta's overflow
        lane) matters only to a join, whose lane is a bitmask."""
        knob = ("siddhi_tpu.partition_window_capacity"
                if self.partition_ctx is not None
                else "siddhi_tpu.window_capacity")
        if any(s.kind in ("distinctcount", "unionset")
               for s in self.selector_plan.specs or []):
            knob += " (or app_context.distinct_values_capacity)"
        return f"window buffer or value table capacity exceeded — raise {knob}"

    _pipeline_ok = True   # a join with a store side stays synchronous

    def _finish_device_batch(self, step, cols, overflow_msg=None) -> Optional[int]:
        """Run the step on the device, then either hand its output to the
        pipeline (depth > 1; the pump hands the wake time to the scheduler
        at drain) or pull its meta, raise on overflow (a full ring or value
        table is never clamped silently) and emit outputs. Returns the
        step's wanted wake time, or None. ``overflow_msg`` (default: the
        query's ``overflow_knob_msg()``) may be a callable of the meta's
        overflow lane: a join decodes its bitmask into the knob to raise."""
        if overflow_msg is None:
            overflow_msg = self.overflow_knob_msg()
        sm = self.app_context.statistics_manager
        t0 = latency_t0(sm)
        jr, self._cur_journey = self._cur_journey, None
        now = self._now()
        if self.selector_plan.needs_str_rank:
            # string order-by keys sort by lexicographic rank, not by id
            cols = dict(cols)
            cols[STR_RANK] = self.dictionary.rank_table()
        if self.captured and hasattr(step, "replay"):
            self._state, out = step.replay(self._state, cols, now,
                                           self.app_context.completion_pump.depth)
        else:
            self._state, out = step(self._state, self._to_device(cols), now)
        out_host = LazyColumns(out)
        pump = self.app_context.completion_pump
        if pump.depth > 1 and self._now_override is None and self._pipeline_ok:
            meta, event = stage_meta(dict.pop(out_host, "__meta__"))
            # the dispatch's latency: the host never waits on the step
            record_elapsed_ms(sm, self.name, t0)
            if jr is not None:
                jr.end_dispatch()     # the device and emit stages close at drain
            pump.submit(QueryCompletion(
                self, out_host, meta, event, overflow_msg,
                junction=self._cur_junction, batch=self._cur_fault_batch,
                journey=jr))
            return None
        if jr is not None:
            # the synchronous device stage: the ride is ~0 (the meta is
            # pulled at once), the blocking pull is the device's service
            jr.end_dispatch()
            jr.pre_drain(journey.ready_of(dict.__getitem__(out_host, "__meta__")))
            t_pull = time.perf_counter()
        meta = self._pull_meta(out_host)     # the one sync of the batch
        if jr is not None:
            jr.drained((time.perf_counter() - t_pull) * 1000.0)
        self.decode_meta_suffix(meta)
        if int(meta[0]) > 0:
            msg = overflow_msg(int(meta[0])) if callable(overflow_msg) else overflow_msg
            raise FatalQueryError(
                f"query '{self.name}': {msg} before creating the runtime")
        record_elapsed_ms(sm, self.name, t0)
        t_e = time.perf_counter() if jr is not None else None
        try:
            if self._timer_horizon is not None and int(meta[2]) > 0:
                for chunk in _chain_chunks(out_host):
                    self._emit(chunk)
            else:
                self._emit(HostBatch(out_host, size=int(meta[2])))
        finally:
            if jr is not None:
                jr.emit_ms = (time.perf_counter() - t_e) * 1000.0
                jr.finish(self.app_context, (self.name,))
        return int(meta[1]) if int(meta[1]) >= 0 else None

    def _pull_meta(self, out_host):
        """Pop and pull the step's packed meta; with a mesh recorded
        (``_shard_mesh``) and ``siddhi_tpu.cluster_step_timeout`` set the
        wait is bounded, so a dead peer surfaces as a labeled
        ``ClusterPeerError`` through the fault machinery instead of hanging
        the runtime (``parallel/distributed.guarded_pull``)."""
        timeout = getattr(self.app_context, "cluster_step_timeout", None)
        if timeout is not None and self._shard_mesh is not None:
            from siddhi_tpu_torch.parallel.distributed import guarded_pull

            return guarded_pull(dict.pop(out_host, "__meta__"), float(timeout),
                                what=f"query '{self.name}' step")
        return out_host.pop("__meta__")

    def _host_keyed_select(self, out_host):
        """Split-pipeline tail: the group key is computed from a stage's
        emitted columns (a pattern's captures, a join's joined rows), so
        the keyer runs on the host between the stage and the selector
        (GroupByKeyGenerator.java:37 over intermediate events). Only the
        emitted rows cross to the host: a stage's output is compacted on
        the device first (a pattern's [rows, slots + 1] match grid is
        mostly empty). Returns (selector output, its row count)."""
        raw = {k: dict.__getitem__(out_host, k) for k in dict.keys(out_host)}
        valid = raw[VALID_KEY]
        if isinstance(valid, torch.Tensor):
            n = valid.shape[0]
            idx = torch.nonzero(valid).squeeze(1)
            if idx.shape[0] < n:
                raw = {k: (v[idx] if (k != STR_RANK and isinstance(v, torch.Tensor)
                                      and v.dim() > 0 and v.shape[0] == n) else v)
                       for k, v in raw.items()}
            out_host = LazyColumns(raw)
        cols = {k: out_host[k] for k in list(dict.keys(out_host))}
        pk = cols.get(PK_KEY) if self.partition_ctx is not None else None
        cols[GK_KEY] = self.keyer(cols, pk=pk)
        self._ensure_capacity()
        if self.selector_plan.needs_str_rank:
            cols[STR_RANK] = self.dictionary.rank_table()
        ctx = {"xp": TorchXP(self.device), "current_time": self._now()}
        if self._sel_step is None:
            self._sel_step = self.app_context.telemetry.instrument_jit(
                lambda st, c, cx: self.selector_plan.apply(st, c, cx),
                f"query.{self.name}.selector", family="selector")
        rl = self._route_layout
        if rl is not None and rl.sel_whole:
            # key-sharded across processes: the selector's state is whole
            # on every process, held as its one shard of the layout
            from siddhi_tpu_torch.parallel.mesh import step_on_own_shard

            sel_out = step_on_own_shard(
                rl, lambda st, c: self._sel_step(st["sel"], c, ctx), self._state,
                self._to_device(cols))
        else:
            self._state["sel"], sel_out = self._sel_step(
                self._state["sel"], self._to_device(cols), ctx)
        out = LazyColumns(pack_meta(sel_out))
        meta = out.pop("__meta__")
        if int(meta[0]) != 0:
            # the selector step's own overflow (distinctCount value-table
            # saturation) must not be silently clamped on the split path
            raise FatalQueryError(
                "selector aggregation overflow — raise "
                "app_context.distinct_values_capacity")
        return out, int(meta[2])

    def _emit(self, out: HostBatch):
        """Columnar re-publish into the output stream: no Event objects
        between queries; columns stay on the device until a consumer reads
        one. A rate limiter takes decoded Events instead."""
        if out.size == 0:
            return
        cols = out.cols
        sp = self.selector_plan
        if sp.uuid_cols:
            # uuid(): fresh UUID strings for every valid row of every uuid
            # column, dictionary-encoded in one bulk pass
            idx = np.nonzero(np.asarray(cols[VALID_KEY]))[0]
            fresh = np.array([str(uuid.uuid4())
                              for _ in range(idx.size * len(sp.uuid_cols))],
                             dtype=object)
            ids = self.dictionary.encode_array(fresh)
            for ci, col in enumerate(sp.uuid_cols):
                vals = np.asarray(cols[col]).copy()
                vals[idx] = ids[ci * idx.size:(ci + 1) * idx.size]
                cols[col] = vals
        from siddhi_tpu_torch.core.query.ratelimit import PassThroughRateLimiter

        limited = (self.rate_limiter is not None
                   and type(self.rate_limiter) is not PassThroughRateLimiter)
        if self.output_action is not None and not limited:
            self.send_to_callbacks(out.to_events(
                self.output_attrs, self.dictionary,
                object_meta=sp.object_meta or None,
                object_multi=set(sp.object_multi) or None))
            return
        if limited:
            self.rate_limiter.process(out.to_events(
                self.output_attrs, self.dictionary,
                object_meta=sp.object_meta or None,
                object_multi=set(sp.object_multi) or None,
                pk_key=PK_KEY if self.limiter_needs_pk else None,
                gk_key=GK_KEY if self.limiter_needs_gk else None))
            return
        events = None
        if self.query_callbacks:
            # decoded before the EXPIRED -> CURRENT flip of the re-publish
            events = out.to_events(self.output_attrs, self.dictionary,
                                   object_meta=sp.object_meta or None,
                                   object_multi=set(sp.object_multi) or None)
        if sp.expired_on:
            # EXPIRED -> CURRENT on re-publish (InsertIntoStreamCallback)
            t = cols[TYPE_KEY]
            cols[TYPE_KEY] = np.where(t == EXPIRED, CURRENT, t).astype(np.int8)
        if self.partition_ctx is not None and not self.attach_pk:
            # rows leaving the partition for a stream outside it: the
            # partition and group key ids are this partition's own, and a
            # window downstream would buffer them as data (an inner
            # '#stream' or a partition-mate keeps them: attach_pk)
            for k in (PK_KEY, GK_KEY):
                dict.pop(cols, k, None)
        self.output_junction.send_batch(HostBatch(cols, size=out._size))
        if events:
            in_events = [e for e in events if not e.is_expired] or None
            remove_events = [e for e in events if e.is_expired] or None
            for cb in self.query_callbacks:
                cb.receive(events[0].timestamp, in_events, remove_events)

    def send_empty_to_query_callbacks(self):
        """Snapshot limiters deliver an empty flush to QueryCallbacks as
        (None, None); stream junctions see nothing."""
        ts = self.app_context.timestamp_generator.current_time()
        for cb in self.query_callbacks:
            cb.receive(ts, None, None)

    def send_to_callbacks(self, events: List[Event]):
        """Output Events (a rate limiter's, or any query's with a table
        action): applied to the table, or re-published (EXPIRED ->
        CURRENT, InsertIntoStreamCallback.java:52-55), then handed to the
        query callbacks."""
        if not events:
            return
        if self.output_action is not None:
            self.output_action(events)
        elif self.output_junction is not None:
            self.output_junction.send_events([
                Event(timestamp=e.timestamp, data=e.data, pk=e.pk)
                if e.is_expired else e for e in events])
        for cb in self.query_callbacks:
            in_events = [e for e in events if not e.is_expired] or None
            remove_events = [e for e in events if e.is_expired] or None
            cb.receive(events[0].timestamp, in_events, remove_events)


class StagingRing:
    """Pinned host staging for one runtime's columns on the card: ``depth
    + 1`` slots, each a pinned buffer per column, and the event recorded
    after the slot's host->device copies. A slot is reused only once its
    event has completed, which it normally has: ``depth`` dispatches have
    gone by since. A column's buffers are allocated in every slot at once,
    by the first batch of a larger size, so pinning memory (slow) is not
    spread over the batches that follow; a slot still in flight keeps its
    old buffer alive through the copy that reads it."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: Dict[str, List[torch.Tensor]] = {}
        self._events: List[Optional[torch.cuda.Event]] = []
        self._next = 0

    def put(self, cols: Dict, depth: int,
            dst: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """The columns on the device: fresh tensors, or with ``dst`` (a
        captured step's static inputs, ``core/query/step_graph.py``)
        copied into its buffers of the same names."""
        while len(self._events) < depth + 1:
            self._events.append(None)
        n_slots = len(self._events)
        i = self._next % n_slots
        self._next += 1
        if self._events[i] is not None:
            self._events[i].synchronize()
        out = {} if dst is None else dst
        for k, v in dict.items(cols):
            if isinstance(v, torch.Tensor):
                if dst is None:
                    out[k] = v.to(self.device, non_blocking=True)
                else:
                    dst[k].copy_(v, non_blocking=True)
                continue
            a = np.asarray(v)
            dt = TORCH_OF_NUMPY.get(a.dtype)
            if dt is None:      # no column type of the port: copied as is
                out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                continue
            bufs = self._bufs.get(k)
            if (bufs is None or len(bufs) < n_slots or bufs[0].dtype != dt
                    or bufs[0].numel() < a.size):
                bufs = self._bufs[k] = [
                    torch.empty(max(a.size, 1), dtype=dt, pin_memory=True)
                    for _ in range(n_slots)]
            staged = bufs[i][:a.size]
            # a read-only source (a wire frame's np.frombuffer view) is
            # only read here
            np.copyto(staged.numpy(), a.reshape(-1))
            if dst is None:
                out[k] = staged.view(a.shape).to(self.device, non_blocking=True)
            else:
                dst[k].copy_(staged.view(a.shape), non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._events[i] = event
        return out


def backfill_null_masks(batch: HostBatch, definition) -> None:
    """A re-published batch omits '?' masks for never-null outputs;
    window buffers key off the full col-spec set, so backfill."""
    cap = dict.__getitem__(batch.cols, VALID_KEY).shape[0]
    for a in definition.attributes:
        if a.name in batch.cols and a.name + "?" not in batch.cols:
            batch.cols[a.name + "?"] = np.zeros(cap, bool)


def pack_meta(out: dict) -> dict:
    """Fold overflow/notify/valid-count into ONE int64 tensor so the host
    pays a single device-to-host copy per batch. The overflow lane carries
    a full window ring or distinct value table; notify is the window's
    next wanted wake time, -1 when it has none."""
    valid = out[VALID_KEY]
    dev = valid.device

    def lane(v, default):
        if v is None:
            return torch.full((), default, dtype=torch.int64, device=dev)
        return torch.as_tensor(v, device=dev).to(torch.int64).reshape(())

    out["__meta__"] = torch.stack([
        lane(out.pop(OVERFLOW_KEY, None), 0),
        lane(out.pop(NOTIFY_KEY, None), -1),
        valid.sum(dtype=torch.int64)])
    return out


def _chain_chunks(cols) -> List[HostBatch]:
    """A swept TIMER step's output as the chunks of the chain steps it
    stands for: its valid rows, in order, cut where their chain step (the
    stage's ``CHUNK_KEY`` lane, else the timestamp: each row's chain time)
    changes."""
    valid = np.asarray(cols[VALID_KEY])
    idx = np.nonzero(valid)[0]
    step = cols.pop(CHUNK_KEY, None)
    step = np.asarray(cols[TS_KEY] if step is None else step)[idx]
    cuts = np.nonzero(np.diff(step))[0] + 1
    chunks = []
    for part in np.split(idx, cuts):
        lo, hi = int(part[0]), int(part[-1]) + 1
        sub = {k: np.asarray(v)[lo:hi] for k, v in cols.items()}
        sub[VALID_KEY] = valid[lo:hi].copy()
        chunks.append(HostBatch(sub, size=len(part)))
    return chunks


def _reset_key_rows(state: dict, init: dict, K: int, idx: torch.Tensor,
                    init_idx: torch.Tensor) -> None:
    """Copy ``init``'s rows ``init_idx`` into ``state``'s rows ``idx``
    along the first axis of size ``K`` of every tensor (in place)."""
    for key, x in state.items():
        x0 = init.get(key)
        if isinstance(x, dict):
            _reset_key_rows(x, x0, K, idx, init_idx)
            continue
        if not isinstance(x, torch.Tensor) or x0 is None:
            continue
        for ax, size in enumerate(x.shape):
            if size == K:
                x.index_copy_(ax, idx, x0.index_select(ax, init_idx).to(x.dtype))
                break


def _min_notify(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    return a if b is None else min(a, b)


def _zero_value(attr_type: AttrType):
    if attr_type == AttrType.STRING:
        return ""
    if attr_type == AttrType.BOOL:
        return False
    return 0


def _string_literals(obj, out: Optional[List[str]] = None) -> List[str]:
    """Every string ``Constant`` of a query-api tree, in walk order."""
    from siddhi_tpu_torch.query_api.expressions import Constant

    if out is None:
        out = []
    if isinstance(obj, Constant):
        if obj.type == AttrType.STRING and isinstance(obj.value, str):
            out.append(obj.value)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _string_literals(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _string_literals(x, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _string_literals(getattr(obj, f.name), out)
    return out


class _Unrenderable(Exception):
    pass


def _render(obj):
    """A deterministic, hashable rendering of a query-api tree (dataclasses,
    enums, containers, scalars); anything else raises ``_Unrenderable``."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return (type(obj).__name__, repr(obj))
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name)
    if isinstance(obj, np.generic):
        return (obj.dtype.str, repr(obj.item()))
    if isinstance(obj, (list, tuple)):
        return tuple(_render(x) for x in obj)
    if isinstance(obj, dict):
        return tuple(sorted((repr(k), _render(v)) for k, v in obj.items()))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, _render(getattr(obj, f.name))) for f in dataclasses.fields(obj))
    raise _Unrenderable(type(obj).__name__)


def _pow2(needed: int, start: int = 16) -> int:
    k = max(start, 1)
    while k < needed:
        k *= 2
    return k


def _copy_prefix_tree(new: dict, old: dict) -> None:
    """Copy old state into the (larger) new tensors along every axis."""
    for key, v in new.items():
        if isinstance(v, dict):
            _copy_prefix_tree(v, old[key])
        else:
            o = old[key]
            v[tuple(slice(0, s) for s in o.shape)] = o

