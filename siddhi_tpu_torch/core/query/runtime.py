"""QueryRuntime: the host side of one compiled query.

Counterpart of ``siddhi_tpu/core/query/runtime.py``: the junction hands
the runtime a columnar batch, the runtime computes partition- and group-
key ids host-side (dense dictionaries), moves the columns to its device,
runs the step (filters + window + selector as torch ops, with the state
updated in place), pulls the packed ``[overflow, notify, count]`` meta in
one copy, raises ``FatalQueryError`` on a capacity overflow and emits the
output rows: columnar into the output stream, decoded to Events for the
query's ``QueryCallback``s (CURRENT rows as ``in_events``, EXPIRED as
``remove_events``), with ``uuid()`` columns filled on the host first.

At ``pipeline_depth`` > 1 the step's output rides the app's
``CompletionPump`` (``core/query/completion.py``) instead: its meta
travels to pinned host memory behind a CUDA event, and the pump emits in
dispatch order once the meta has arrived, while the producer packs the
next batch. Depth 1 pulls the meta at once, as the reference does. On the
card, host columns reach the step through a ring of ``depth + 1`` pinned
staging slots per column with ``non_blocking`` copies, so packing the
next batch never waits behind the card's queue; a slot is written again
only once the event recorded after its last copy has completed.
"""

from __future__ import annotations

import threading
import uuid
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.core.event import (
    CURRENT, EXPIRED, Event, HostBatch, LazyColumns, StringDictionary,
    encode_key_tuples, pack_pool_of)
from siddhi_tpu_torch.core.plan.selector_plan import GK_KEY, STR_RANK, SelectorPlan
from siddhi_tpu_torch.core.query.completion import QueryCompletion, stage_meta
from siddhi_tpu_torch.core.stream.junction import (
    FatalQueryError, Receiver, current_delivering_junction)
from siddhi_tpu_torch.ops.expressions import (
    NUMPY_XP, PK_KEY, TYPE_KEY, VALID_KEY, TorchXP)
from siddhi_tpu_torch.ops.types import TORCH_OF_NUMPY
from siddhi_tpu_torch.ops.windows import conform_cols
from siddhi_tpu_torch.query_api.definitions import AttrType, StreamDefinition


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
    def __init__(self, name: str, app_context, input_definition: StreamDefinition,
                 filters: List[Callable], window_stage, selector_plan: SelectorPlan,
                 keyer: Optional[GroupKeyer], dictionary: StringDictionary,
                 partition_ctx=None, partition_keyer=None, post_filters=None):
        self.name = name
        self.app_context = app_context
        self.device = app_context.device
        self.input_definition = input_definition
        self.filters = filters
        self.post_filters = post_filters or []  # masks on window-emitted rows
        self.window_stage = window_stage
        self.selector_plan = selector_plan
        self.keyer = keyer
        self.dictionary = dictionary
        self.partition_ctx = partition_ctx
        self.partition_keyer = partition_keyer
        self._win_keys = 1
        if partition_ctx is not None:
            self._win_keys = max(_pow2(partition_ctx.num_keys()), 16)
        self.output_junction = None
        self._state: Optional[dict] = None
        self._step = None
        self._route_layout = None  # parallel.mesh.device_route_query_step
        self.query_callbacks: List = []
        self._lock = threading.RLock()
        self._staging: Optional[StagingRing] = None
        # the delivering junction of the batch in process_batch, and its
        # input batch when that junction routes errors to a fault stream
        self._cur_junction = None
        self._cur_fault_batch = None

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
        self.selector_plan.num_keys = new_k
        self._win_keys = new_w
        old_state = self._state
        self._state = self._init_state()
        if old_state is not None:
            _copy_prefix_tree(self._state, old_state)
        self._step = None

    def _make_step(self):
        if self._route_layout is not None:
            # a cleared step on a routed runtime must come back ROUTED
            from siddhi_tpu_torch.parallel.mesh import routed_step_for

            return routed_step_for(self)
        return self.build_step_fn()

    def build_step_fn(self):
        """The (state, cols, now) -> (state, out) step of this query. The
        state tensors are updated in place and returned; ``cols`` are
        tensors on the state's device."""
        filters = list(self.filters)
        post_filters = list(self.post_filters)
        sel = self.selector_plan
        win = self.window_stage
        xp = TorchXP(self.device)

        def step(state, cols, current_time):
            ctx = {"xp": xp, "current_time": current_time}
            cols = dict(cols)
            strrank = cols.pop(STR_RANK, None)   # window stages rebuild cols
            valid = cols[VALID_KEY]
            timer = cols[TYPE_KEY] == 2
            for f in filters:
                valid = valid & (f(cols, ctx) | timer)
            cols[VALID_KEY] = valid
            if win is not None:
                _st, cols = win.apply(state["win"], conform_cols(win, cols), ctx)
                cols = dict(cols)
                ptimer = cols[TYPE_KEY] == 2
                for f in post_filters:
                    cols[VALID_KEY] = cols[VALID_KEY] & (f(cols, ctx) | ptimer)
            if strrank is not None:
                cols[STR_RANK] = strrank
            _st, out = sel.apply(state["sel"], cols, ctx)
            return state, pack_meta(out)

        return step

    # ----------------------------------------------------------- processing

    def receive(self, events: List[Event]):
        self.process_batch(HostBatch.from_events(
            events, self.input_definition, self.dictionary,
            pool=pack_pool_of(self.app_context)))

    def receive_batch(self, batch: HostBatch, junction=None):
        backfill_null_masks(batch, self.input_definition)
        self.process_batch(batch, junction=junction)

    def _now(self) -> int:
        return int(self.app_context.timestamp_generator.current_time())

    def process_batch(self, batch: HostBatch, junction=None):
        with self._lock:
            # Event-path deliveries carry no junction parameter: the
            # delivery loop's thread-local names it, so pipelined
            # completions keep their error routing and latency feedback
            j = junction or current_delivering_junction()
            self._cur_junction = j
            self._cur_fault_batch = batch if (
                j is not None and j.on_error_action == "STREAM"
                and j.fault_junction is not None) else None
            # a re-published batch may hold device tensors: the keyers'
            # reads pull them to the host in one copy, a step without
            # keyers takes them as they are
            cols = LazyColumns(batch.cols)
            partitioned = self.partition_ctx is not None
            pk = None
            if partitioned:
                cols, pk = self.partition_keyer.apply(cols)
                cols = dict(cols)
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
                from siddhi_tpu_torch.parallel.mesh import prepare_routed_batches

                for piece in prepare_routed_batches(self, cols):
                    self._finish_device_batch(self._step, piece)
            else:
                self._finish_device_batch(self._step, cols)

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

    def overflow_knob_msg(self) -> str:
        """The capacity-overflow message naming its knob. Of the ported
        stages only a distinctCount/unionSet value table can fill (the
        windows' rings never overflow)."""
        return ("distinctCount/unionSet value table full — raise "
                "app_context.distinct_values_capacity")

    def decode_meta_suffix(self, meta: np.ndarray) -> None:
        """The routed step's meta carries [ov, notify, count,
        route_overflow, rows_0..rows_n-1]: count the overflowed rows and
        raise on any (an exchange overflow is fatal for the batch)."""
        rl = self._route_layout
        if rl is not None:
            rl.route_overflow_rows += int(meta[3])
            if int(meta[3]) > 0:
                raise FatalQueryError(f"query '{self.name}': {self.route_overflow_msg()}")

    def _finish_device_batch(self, step, cols) -> None:
        """Run the step on the device, then either hand its output to the
        pipeline (depth > 1) or pull its meta, raise on overflow (a full
        value table is never clamped silently) and emit outputs. The
        ported stages never ask for a timer."""
        now = self._now()
        if self.selector_plan.needs_str_rank:
            # string order-by keys sort by lexicographic rank, not by id
            cols = dict(cols)
            cols[STR_RANK] = self.dictionary.rank_table()
        self._state, out = step(self._state, self._to_device(cols), now)
        out_host = LazyColumns(out)
        pump = self.app_context.completion_pump
        if pump.depth > 1:
            meta, event = stage_meta(dict.pop(out_host, "__meta__"))
            pump.submit(QueryCompletion(
                self, out_host, meta, event, self.overflow_knob_msg(),
                junction=self._cur_junction, batch=self._cur_fault_batch))
            return
        meta = out_host.pop("__meta__")     # the one sync of the batch
        self.decode_meta_suffix(meta)
        if int(meta[0]) > 0:
            raise FatalQueryError(
                f"query '{self.name}': {self.overflow_knob_msg()} before "
                f"creating the runtime")
        self._emit(HostBatch(out_host, size=int(meta[2])))

    def _emit(self, out: HostBatch):
        """Columnar re-publish into the output stream: no Event objects
        between queries; columns stay on the device until a consumer reads
        one."""
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
        self.output_junction.send_batch(HostBatch(cols, size=out._size))
        if events:
            in_events = [e for e in events if not e.is_expired] or None
            remove_events = [e for e in events if e.is_expired] or None
            for cb in self.query_callbacks:
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

    def put(self, cols: Dict, depth: int) -> Dict[str, torch.Tensor]:
        while len(self._events) < depth + 1:
            self._events.append(None)
        n_slots = len(self._events)
        i = self._next % n_slots
        self._next += 1
        if self._events[i] is not None:
            self._events[i].synchronize()
        out = {}
        for k, v in dict.items(cols):
            if isinstance(v, torch.Tensor):
                out[k] = v.to(self.device, non_blocking=True)
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
            out[k] = staged.view(a.shape).to(self.device, non_blocking=True)
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
    the selector's ``__overflow__`` (a full distinct value table); the
    ported stages never ask for a timer, so notify is -1."""
    valid = out[VALID_KEY]
    ov = out.pop("__overflow__", None)
    ov = (torch.zeros((), dtype=torch.int64, device=valid.device) if ov is None
          else ov.to(torch.int64).reshape(()))
    out["__meta__"] = torch.stack([
        ov, torch.full((), -1, dtype=torch.int64, device=valid.device),
        valid.sum(dtype=torch.int64)])
    return out


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

