"""StepGraph: a fused fan-out step captured once as a CUDA graph and
replayed for every batch.

The port's counterpart of the reference's ``jax.jit(fused,
donate_argnums=0)`` (``siddhi_tpu/core/query/fused_fanout.py:434``): jit
traces the fused step once per input shape and dispatches the compiled
program as one call; here the step (every member's torch ops and the
distinct-scan kernel) is captured once with ``torch.cuda.graph`` and each
batch is one ``replay()``, so the host enqueues one graph instead of the
members' several hundred kernels.

A graph binds addresses, so everything it reads or writes stays put:

- **inputs**: one static device buffer per column, written by one
  host-to-device copy per column from the runtime's pinned staging ring
  (``StagingRing.put`` with ``dst``), and a 0-d int64 device tensor for
  the clock, filled before each replay. A step therefore receives
  ``current_time`` as a tensor; a stage that declares ``capturable``
  takes it so (a Python int would be baked into the graph);
- **state**: the members' state tensors, updated in place by the replay.
  The data pointers of every state leaf are part of the graph's binding:
  a restore, a capacity growth or anything else that replaces a state
  tensor makes every graph stale, and the next batch re-captures;
- **outputs** live in the graph's private pool and the next replay
  overwrites them, so each output tensor is cloned on the replay's
  stream right after it (a completion riding the pipeline, or a batch
  re-published into a downstream junction, keeps its own copy). The
  stacked meta is returned as is: the caller stages or pulls it before
  the next replay.

One graph is kept per signature (every input column's name, dtype and
shape, which covers the batch capacity and the string rank table's size);
a short last batch gets a graph of its own, as jit compiles one program
per shape. ``drop()`` frees them all; the group calls it when it rebuilds
its step (a member slot or key capacity changed), on restore, on release
and dissolve, and at shutdown.

Capture: one eager warm-up on a side stream, over a copy of the states
(the step updates state in place), loads the kernels' libraries and
settles the allocator; then ``torch.cuda.graph`` captures the step on the
real states, and one replay runs the batch. Nothing host-side may happen
inside the step: a host read under capture raises, and the failure is
raised to the caller (there is no eager fallback; the group decides the
mode from its members' declarations). A kernel wrapper's ``launches``
counter counts Python calls, which a replay does not make: the launches
made under capture are taken back from the counters and added again at
every replay (``launch_counters``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.ops.types import TORCH_OF_NUMPY


def launch_counters() -> Tuple:
    """The kernel wrappers whose ``launches`` attribute a graph keeps
    true under replay: the distinct scan, the one kernel a capturable
    step launches (the exchange runs on routed steps, which never fuse)."""
    from siddhi_tpu_torch.ops.distinct import distinct_scan

    return (distinct_scan,)


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
    """The captured graphs of one fused step (see the module doc)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._graphs: Dict[tuple, _Captured] = {}
        self._bind: Optional[tuple] = None
        self._staging = None
        self.captures = 0        # graphs captured over the group's life
        self.replays = 0
        self.capture_ms = 0.0    # wall ms of the last capture (warm-up included)

    @property
    def pool_bytes(self) -> int:
        """Device bytes the live graphs hold (their pools and inputs)."""
        return sum(c.pool_bytes for c in self._graphs.values())

    def drop(self) -> None:
        self._graphs.clear()
        self._bind = None

    def close(self) -> None:
        """Free the graphs and the pinned staging slots."""
        self.drop()
        self._staging = None

    def run(self, fn, states, cols: Dict, now: int, depth: int):
        """One batch through the captured step: ``fn(states, cols, now) ->
        (outs, metas)`` with ``states`` the tuple the step updates in
        place. Returns ``(outs, metas, capture_ms)``: ``outs`` cloned,
        ``metas`` valid until the next replay, ``capture_ms`` the wall
        time of a capture this batch needed, else None."""
        from siddhi_tpu_torch.core.query.runtime import StagingRing

        if self._staging is None:
            self._staging = StagingRing(self.device)
        bind = tuple(t.data_ptr() for t in state_leaves(states))
        if bind != self._bind:
            self.drop()
            self._bind = bind
        spec = column_spec(cols)
        cap = self._graphs.get(spec)
        capture_ms = None
        if cap is None:
            t0 = time.perf_counter()
            cap = self._capture(fn, states, cols, now, depth, spec)
            self._graphs[spec] = cap
            self.captures += 1
            capture_ms = self.capture_ms = (time.perf_counter() - t0) * 1000.0
        else:
            self._stage(cap, cols, now, depth)
        cap.graph.replay()
        self.replays += 1
        for counter, n in cap.launches:
            counter.launches += n
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
        return tuple(outs), cap.metas, capture_ms

    def _stage(self, cap: _Captured, cols: Dict, now: int, depth: int) -> None:
        self._staging.put(cols, depth, dst=cap.inputs)
        cap.now.fill_(int(now))

    def _capture(self, fn, states, cols, now, depth, spec) -> _Captured:
        dev = self.device
        inputs = {k: torch.empty(shape, dtype=dt, device=dev)
                  for k, dt, shape in spec}
        now_t = torch.zeros((), dtype=torch.int64, device=dev)
        mem0 = torch.cuda.memory_allocated(dev)
        cap = _Captured(None, inputs, now_t, None, None, (), 0)
        self._stage(cap, cols, now, depth)
        # warm-up on a copy of the states: the libraries load and the
        # allocator settles outside the capture
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn(clone_tree(states), inputs, now_t)
        cur.wait_stream(side)
        counters = launch_counters()
        before = [c.launches for c in counters]
        graph = torch.cuda.CUDAGraph()
        # thread-local: an @Async worker, a timer or a REST handler on
        # another thread may use the card while this one captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outs, metas = fn(states, inputs, now_t)
        launches = []
        for c, n0 in zip(counters, before):
            n = c.launches - n0
            if n:
                c.launches -= n      # the capture recorded, it launched nothing
                launches.append((c, n))
        cap.graph, cap.outs, cap.metas = graph, outs, metas
        cap.launches = tuple(launches)
        cap.pool_bytes = torch.cuda.memory_allocated(dev) - mem0
        return cap
