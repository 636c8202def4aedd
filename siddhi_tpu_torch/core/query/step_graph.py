"""StepGraph: a step captured once as a CUDA graph and replayed for every
batch; private to one runtime, or shared by every app of a program-cache
entry.

The port's counterpart of the reference's per-step ``jax.jit`` (a single
query's step, a routed step, a fused fan-out group's step): jit traces a
step once per input shape and dispatches the compiled program as one
call; here the step (its torch ops and the hand-written kernels it
launches, the distinct scan and the ring exchange) is captured once with
``torch.cuda.graph`` and each later batch is one ``replay()``, so the host
enqueues one graph instead of a few hundred kernels.

A graph binds addresses, so everything it reads or writes stays put:

- **inputs**: one static device buffer per column, written by one
  host-to-device copy per column from a pinned staging ring
  (``StagingRing.put`` with ``dst``; a column already on the card, such
  as a routed step's key LUT, is one device copy), and a 0-d int64 device
  tensor for the clock, filled before each replay. A step therefore
  receives ``current_time`` as a tensor; a stage that declares
  ``capturable`` takes it so (a Python int would be baked into the graph);
- **state**: a private graph is captured over its runtime's own state
  tensors, updated in place by the replay; their data pointers are part
  of its binding, so a restore, a capacity growth or anything else that
  replaces a state tensor makes every graph stale, and the next batch
  re-captures. A **shared** graph (``shared=True``, a program-cache
  entry's: ``core/util/program_cache.py``) is captured over the entry's
  own slot state, made once in the state's shapes. Every sharer copies
  its state into the slot, replays, and copies the slot back
  (``torch._foreach_copy_``: a few launches move every leaf), all outside
  the graph and under the graph's lock; so a hit captures nothing, and a
  restore of a sharer's state re-captures nothing;
- **outputs** live in the graph's private pool and the next replay
  overwrites them, so each output tensor is cloned on the replay's stream
  right after it (a completion riding the pipeline, or a batch
  re-published into a downstream junction, keeps its own copy). A private
  graph returns the stacked meta as is (the caller stages or pulls it
  before the next replay); a shared graph clones it before its lock is
  released, since another app's replay overwrites it.

One graph is kept per signature (every input column's name, dtype and
shape, which covers the batch capacity and the string rank table's size);
a short last batch gets a graph of its own, as jit compiles one program
per shape. ``drop()`` frees them all; ``close()`` frees the slot too.

Capture: the batch that meets a new signature runs eagerly, on fresh
device copies of its columns and on the caller's real state (this run is
the batch's result, and it loads the kernels' libraries and settles the
allocator, the warm-up a capture needs); then ``torch.cuda.graph``
records the step over the bound state and the static inputs without
running it. Nothing host-side may happen inside the step: a host read
under capture raises, and the failure is raised to the caller (there is
no eager fallback; the runtime decides the mode from its stages'
declarations). A kernel wrapper's counter counts Python calls, which a
replay does not make: the launches recorded under capture are taken back
from the counters and added again at every replay (``launch_counters``),
so a wrapper's ``launches`` stays the number of kernel launches the card
ran.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.ops.types import TORCH_OF_NUMPY


def launch_counters() -> Tuple:
    """(object, attribute) of every kernel-wrapper counter a graph keeps
    true under replay: the distinct scan's launches, and the ring
    exchange's launches and the columns they moved."""
    from siddhi_tpu_torch.ops.distinct import distinct_scan
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    return ((distinct_scan, "launches"), (ring_exchange, "launches"),
            (ring_exchange, "columns"))


def state_leaves(tree, out: Optional[List] = None) -> List[torch.Tensor]:
    """The tensors of a state tree (dicts, lists and tuples), in order."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            state_leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            state_leaves(v, out)
    return out


def clone_tree(tree):
    """A copy of a state tree with every tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


def column_spec(cols: Dict) -> tuple:
    """(name, torch dtype, shape) of every column, in name order: the
    shape half of a graph's signature. Raises for a column no graph input
    can hold."""
    spec = []
    for k in sorted(dict.keys(cols)):
        v = dict.__getitem__(cols, k)
        if isinstance(v, torch.Tensor):
            spec.append((k, v.dtype, tuple(v.shape)))
            continue
        a = np.asarray(v)
        dt = TORCH_OF_NUMPY.get(a.dtype)
        if dt is None:
            raise TypeError(f"column '{k}' of dtype {a.dtype} cannot enter a "
                            f"captured step")
        spec.append((k, dt, a.shape))
    return tuple(spec)


def device_cols(cols: Dict, device) -> Dict[str, torch.Tensor]:
    """Every column as a tensor on ``device`` (plain copies: a cost
    capture's inputs, off the hot path)."""
    out = {}
    for k, v in dict.items(cols):
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device)
    return out


def packed(fn):
    """A ``(state, cols, now) -> (state, out)`` query step whose ``out``
    carries its ``__meta__``, as a ``(state, cols, now) -> ((out,),
    meta)`` step, the form a graph runs."""
    def split(state, cols, now):
        _st, out = fn(state, cols, now)
        out = dict(out)
        meta = out.pop("__meta__")
        return (out,), meta

    return split


class _Captured:
    __slots__ = ("graph", "inputs", "now", "outs", "metas", "launches",
                 "pool_bytes")

    def __init__(self, graph, inputs, now, outs, metas, launches, pool_bytes):
        self.graph = graph
        self.inputs = inputs
        self.now = now
        self.outs = outs
        self.metas = metas
        self.launches = launches
        self.pool_bytes = pool_bytes


class StepGraph:
    """The captured graphs of one step (see the module doc)."""

    # captures made by every graph of the process (a graph object may be
    # freed with its cache entry, and its own count with it)
    total_captures = 0

    def __init__(self, device: torch.device, shared: bool = False):
        self.device = device
        self.shared = shared
        self._graphs: Dict[tuple, _Captured] = {}
        self._bind: Optional[tuple] = None
        self._staging = None
        self._slot = None          # shared mode: the entry's own state
        self._slot_leaves: List[torch.Tensor] = []
        self._lock = threading.Lock()
        self.captures = 0        # graphs captured over the graph's life
        self.replays = 0
        self.capture_ms = 0.0    # wall ms of the last capture (its eager run included)
        # shared mode: CUDA events around each replay's copy-in and
        # copy-out while ``time_copies`` is set (read by ``copy_times``)
        self.time_copies = False
        self._copy_events: List[Tuple] = []

    @property
    def pool_bytes(self) -> int:
        """Device bytes the live graphs hold (their pools and inputs)."""
        return sum(c.pool_bytes for c in self._graphs.values())

    @property
    def slot_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._slot_leaves)

    @property
    def graph_count(self) -> int:
        return len(self._graphs)

    def drop(self) -> None:
        self._graphs.clear()
        self._bind = None

    def close(self) -> None:
        """Free the graphs, the slot and the pinned staging slots."""
        with self._lock:
            self.drop()
            self._slot = None
            self._slot_leaves = []
            self._staging = None

    def run(self, fn, states, cols: Dict, now: int, depth: int):
        """One batch through the captured step: ``fn(states, cols, now) ->
        (outs, metas)`` with ``states`` the tree the step updates in
        place. Returns ``(outs, metas, capture_ms)``: ``outs`` cloned,
        ``metas`` valid until the next replay (a shared graph's cloned),
        ``capture_ms`` the wall time of a capture this batch needed (its
        eager run included), else None."""
        if not self.shared:
            bind = tuple(t.data_ptr() for t in state_leaves(states))
            if bind != self._bind:
                self.drop()
                self._bind = bind
            return self._run(fn, states, states, cols, now, depth)
        with self._lock:
            leaves = state_leaves(states)
            if self._slot is None:
                self._slot = clone_tree(states)
                self._slot_leaves = state_leaves(self._slot)
            return self._run(fn, states, self._slot, cols, now, depth, leaves)

    def _run(self, fn, states, bound, cols, now, depth, leaves=None):
        from siddhi_tpu_torch.core.query.runtime import StagingRing

        if self._staging is None:
            self._staging = StagingRing(self.device)
        spec = column_spec(cols)
        cap = self._graphs.get(spec)
        if cap is None:
            t0 = time.perf_counter()
            outs, metas, cap = self._capture(fn, states, bound, cols, now, depth, spec)
            self._graphs[spec] = cap
            self.captures += 1
            StepGraph.total_captures += 1
            self.capture_ms = (time.perf_counter() - t0) * 1000.0
            return outs, metas, self.capture_ms
        self._staging.put(cols, depth, dst=cap.inputs)
        cap.now.fill_(int(now))
        # ``leaves`` None: a private graph; empty: a stateless shared step
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(4)]
              if leaves and self.time_copies else None)
        if leaves:
            if ev:
                ev[0].record()
            torch._foreach_copy_(self._slot_leaves, leaves)
            if ev:
                ev[1].record()
        cap.graph.replay()
        self.replays += 1
        for (obj, attr), n in cap.launches:
            setattr(obj, attr, getattr(obj, attr) + n)
        clones: Dict[int, torch.Tensor] = {}   # one clone a tensor
        outs = []
        for out in cap.outs:
            mine = {}
            for k, v in out.items():
                c = clones.get(id(v))
                if c is None:
                    c = clones[id(v)] = v.clone()
                mine[k] = c
            outs.append(mine)
        metas = cap.metas
        if leaves is not None:
            metas = metas.clone()
        if leaves:
            if ev:
                ev[2].record()
            torch._foreach_copy_(leaves, self._slot_leaves)
            if ev:
                ev[3].record()
                self._copy_events.append(ev)
        return tuple(outs), metas, None

    def copy_times(self) -> List[Tuple[float, float]]:
        """(copy-in ms, copy-out ms) of each replay timed since the last
        call (CUDA events; synchronizes on the last one)."""
        evs, self._copy_events = self._copy_events, []
        if evs:
            evs[-1][3].synchronize()
        return [(e[0].elapsed_time(e[1]), e[2].elapsed_time(e[3])) for e in evs]

    def _capture(self, fn, states, bound, cols, now, depth, spec):
        """The batch eagerly on ``states`` (its result), then a capture of
        the step over ``bound`` and fresh static inputs, not run."""
        dev = self.device
        now_t = torch.full((), int(now), dtype=torch.int64, device=dev)
        outs, metas = fn(states, self._staging.put(cols, depth), now_t)
        inputs = {k: torch.empty(shape, dtype=dt, device=dev)
                  for k, dt, shape in spec}
        now_c = torch.zeros((), dtype=torch.int64, device=dev)
        mem0 = torch.cuda.memory_allocated(dev)
        counters = launch_counters()
        before = [getattr(obj, attr) for obj, attr in counters]
        graph = torch.cuda.CUDAGraph()
        # thread-local: an @Async worker, a timer or a REST handler on
        # another thread may use the card while this one captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            c_outs, c_metas = fn(bound, inputs, now_c)
        launches = []
        for (obj, attr), n0 in zip(counters, before):
            n = getattr(obj, attr) - n0
            if n:
                # the capture recorded these launches; it launched nothing
                setattr(obj, attr, getattr(obj, attr) - n)
                launches.append(((obj, attr), n))
        in_bytes = sum(t.numel() * t.element_size() for t in inputs.values())
        cap = _Captured(graph, inputs, now_c, c_outs, c_metas, tuple(launches),
                        torch.cuda.memory_allocated(dev) - mem0 + in_bytes)
        return outs, metas, cap
