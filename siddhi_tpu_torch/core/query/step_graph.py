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
running it, one capture at a time in the process (``torch.cuda.graph``
captures on one process-wide stream and synchronizes the device as it
begins, so two threads must not capture at once). Nothing host-side
may happen inside the step: a host read under capture raises, and the
failure is raised to the caller (there is no eager fallback; the runtime
decides the mode from its stages'
declarations). A kernel wrapper's counter counts Python calls, which a
replay does not make: the launches a capture records go to its own tally
(``ops/_cuda.capture_tally``, per thread, so another thread's launches
meanwhile still count) and are added at every replay, so a wrapper's
``launches`` stays the number of kernel launches the card ran.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from siddhi_tpu_torch.ops import _cuda
from siddhi_tpu_torch.ops.types import TORCH_OF_NUMPY


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
    # one capture at a time in the process: ``torch.cuda.graph`` captures
    # on one process-wide stream and enters with a device synchronize, so
    # a second thread's capture (two @Async streams meeting their first
    # batch together) would break the first
    _capture_lock = threading.Lock()

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

    def run(self, fn, states, cols: Dict, now: int, depth: int,
            on_capture=None):
        """One batch through the captured step: ``fn(states, cols, now) ->
        (outs, metas)`` with ``states`` the tree the step updates in
        place. Returns ``(outs, metas, capture_ms)``: ``outs`` cloned,
        ``metas`` valid until the next replay (a shared graph's cloned),
        ``capture_ms`` the wall time of a capture this batch needed (its
        eager run included), else None. ``on_capture()`` is called before
        each capture: the step instrument's recapture watchdog
        (``analysis/sanitize.check_recompile``), which raises to refuse
        it."""
        if not self.shared:
            bind = tuple(t.data_ptr() for t in state_leaves(states))
            if bind != self._bind:
                self.drop()
                self._bind = bind
            return self._run(fn, states, states, cols, now, depth,
                             on_capture=on_capture)
        with self._lock:
            leaves = state_leaves(states)
            if self._slot is None:
                self._slot = clone_tree(states)
                self._slot_leaves = state_leaves(self._slot)
            return self._run(fn, states, self._slot, cols, now, depth, leaves,
                             on_capture)

    def _run(self, fn, states, bound, cols, now, depth, leaves=None,
             on_capture=None):
        from siddhi_tpu_torch.core.query.runtime import StagingRing

        if self._staging is None:
            self._staging = StagingRing(self.device)
        spec = column_spec(cols)
        cap = self._graphs.get(spec)
        if cap is None:
            if on_capture is not None:
                on_capture()
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
        if leaves:
            torch._foreach_copy_(self._slot_leaves, leaves)
        cap.graph.replay()
        self.replays += 1
        for (wrapper, attr), n in cap.launches:
            _cuda.count(wrapper, attr, n)
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
            torch._foreach_copy_(leaves, self._slot_leaves)
        return tuple(outs), metas, None

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
        graph = torch.cuda.CUDAGraph()
        # thread-local: an @Async worker, a timer or a REST handler on
        # another thread may use the card while this one captures; the
        # launches the capture records go to its tally, not the counters
        with StepGraph._capture_lock, _cuda.capture_tally() as tally, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            c_outs, c_metas = fn(bound, inputs, now_c)
        launches = tuple(tally.items())
        in_bytes = sum(t.numel() * t.element_size() for t in inputs.values())
        cap = _Captured(graph, inputs, now_c, c_outs, c_metas, tuple(launches),
                        torch.cuda.memory_allocated(dev) - mem0 + in_bytes)
        return outs, metas, cap
