"""Step-program cost registry: what does each step program do?

Counterpart of ``siddhi_tpu/observability/costmodel.py``, the registry
behind ``GET /programs``. When enabled, the first call of every
instrumented step (``telemetry.InstrumentedJit``) also captures

- ``flops`` and ``bytes_accessed``: one eager run of the step on a clone
  of its state, under a ``TorchDispatchMode`` that adds each aten op's
  output elements to ``flops`` (the reference's XLA cost analysis counts
  elementwise work the same way: one op an element) and the bytes of its
  tensor inputs and outputs to ``bytes_accessed``;
- ``arg_bytes`` (the state and the inputs), ``out_bytes`` (the outputs)
  and, on the card, ``temp_bytes`` (the device memory the run allocated
  beyond them, the counterpart of a graph pool); ``code_bytes`` stays 0:
  the port compiles no program of its own;
- on the card only, ``extra["kernels"]`` and ``extra["device_us"]``: the
  kernels the run launched and their device time under
  ``torch.profiler``;
- a **fingerprint**: the first 16 hex digits of the sha1 of the step's
  witness (``core/util/program_cache.Witness``). Steps with equal
  fingerprints are the same program; a cluster of more than one key is a
  program built more than once, a candidate for sharing.

The numbers are not XLA's: the port fuses nothing, so ``bytes_accessed``
counts every op's inputs and outputs where XLA counts a fused kernel's
once, and ``flops`` counts the ops a fusion would keep in registers.
Read them as the port's own dispatch counts, comparable between the
port's steps, not with the reference's.

Exported as ``jitcost.<key>.<metric>`` process gauges (rendered as the
``siddhi_jit_cost_*{key}`` families on ``GET /metrics``) and as JSON at
``GET /programs`` with its fingerprint clusters.

Only a capturable step (a pure device function of its state, inputs and
clock, as its stages declare) is run for its costs: an eager-only step
(a pattern's, a join side's, the split path's selector) reads and writes
host state around its device ops, and a second run would disturb it. Its
record holds the fingerprint and ``arg_bytes`` only, with
``extra["measured"] = 0``.

Cost of capture: one extra eager run of the step per key at its first
call (the instrument runs the capture before the call, on cloned state,
so the real step's state is untouched). Steady state is untouched, and
the default is off: enable per app with ``siddhi_tpu.profile_costs:
true``, process-wide with ``SIDDHI_TPU_PROFILE_COSTS=1`` or ``POST
/profile/costs/start``. A step sharing another app's program copies that
program's record (``shared``) instead of running again.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

_enable_count = 0
_lock = threading.RLock()


def enabled() -> bool:
    if _enable_count > 0:
        return True
    # re-read per call so a test can flip it: called once per first call
    from siddhi_tpu_torch.core.util.knobs import env_knob

    return bool(env_knob("SIDDHI_TPU_PROFILE_COSTS", "bool", False))


def enable() -> None:
    """Refcounted process-wide enable (one ``disable()`` per
    ``enable()``); the env spelling is an independent override."""
    global _enable_count
    with _lock:
        _enable_count += 1


def disable(force: bool = False) -> None:
    global _enable_count
    with _lock:
        _enable_count = 0 if force else max(0, _enable_count - 1)


@dataclass
class ProgramRecord:
    """One step program (per instrument key; a rebuilt step re-captures
    under its key)."""

    key: str
    fingerprint: str            # sha1[:16] of the step's witness
    platform: str = ""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    arg_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int = 0
    code_bytes: int = 0
    compile_ms: float = 0.0     # the capture's own eager run
    captures: int = 1           # how many times this key re-captured
    shared: bool = False        # the record copied from an equal program
    error: Optional[str] = None
    extra: Dict[str, float] = field(default_factory=dict)


def _tensors(tree, out: List) -> List:
    import torch

    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree, []))


def _counting_mode():
    """A ``TorchDispatchMode`` that counts each aten op's output elements
    (``flops``) and its tensor inputs' and outputs' bytes
    (``bytes_accessed``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counting(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = _tensors(out, [])
            self.flops += sum(t.numel() for t in outs)
            self.bytes += _nbytes(list(args) + list((kwargs or {}).values())) + _nbytes(outs)
            return out

    return Counting()


class CostRegistry:
    """Process-global program registry (``registry()``), fed by
    ``InstrumentedJit`` and read by ``GET /programs`` and the
    ``siddhi_jit_cost_*`` exposition."""

    _GAUGE_METRICS = ("flops", "bytes_accessed", "arg_bytes", "out_bytes",
                      "temp_bytes", "code_bytes", "compile_ms")

    def __init__(self):
        self._lock = threading.RLock()
        self._programs: Dict[str, ProgramRecord] = {}

    # ------------------------------------------------------------ capture

    def capture(self, key: str, fn, args, witness, shared: bool = False,
                graph: bool = False, packed: bool = False,
                run: bool = True) -> Optional[ProgramRecord]:
        """Costs of one step about to run its first call: ``fn(*args)``
        once, eagerly, on a clone of the state (``args[0]``) and on device
        copies of the columns (``args[1]``; a graph step's are host
        arrays). Never raises: a failure is recorded in ``error`` and the
        engine runs on. ``shared``: the step dispatches through an equal
        program's callable, whose record is copied when there is one.
        ``run`` False (an eager-only step): nothing is run."""
        from siddhi_tpu_torch.core.query import step_graph

        rec = ProgramRecord(key=key, fingerprint=witness.fingerprint(),
                            platform=witness.device)
        try:
            if shared:
                donor = self._donor(rec.fingerprint, key)
                if donor is not None:
                    for metric in self._GAUGE_METRICS + ("extra",):
                        setattr(rec, metric, getattr(donor, metric))
                    rec.compile_ms = 0.0
                    rec.shared = True
                    self._store(rec)
                    return rec
            if run:
                self._measure(rec, fn, args, graph, step_graph)
            else:
                rec.arg_bytes = _nbytes(list(args))
                rec.extra = {"measured": 0.0}
        except Exception as e:  # noqa: BLE001 — profiling must not break a step
            log.debug("cost capture failed for step '%s': %r", key, e)
            rec.error = repr(e)
        self._store(rec)
        return rec

    def _measure(self, rec: ProgramRecord, fn, args, graph: bool, step_graph):
        import torch

        state = step_graph.clone_tree(args[0])
        leaves = step_graph.state_leaves(state)
        device = leaves[0].device if leaves else torch.device("cpu")
        rest = list(args[1:])
        if rest and isinstance(rest[0], dict):
            rest[0] = step_graph.device_cols(rest[0], device)
        if graph and len(rest) > 1:
            # a graph step takes the clock as a 0-d tensor
            rest[1] = torch.full((), int(rest[1]), dtype=torch.int64, device=device)
        rec.arg_bytes = _nbytes(state) + _nbytes(rest)
        cuda = device.type == "cuda"
        mode = _counting_mode()
        mem0 = torch.cuda.memory_allocated(device) if cuda else 0
        prof = None
        if cuda:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize(device)
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        try:
            with mode:
                out = fn(state, *rest)
            if cuda:
                torch.cuda.synchronize(device)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        rec.compile_ms = (time.perf_counter() - t0) * 1000.0
        rec.flops = float(mode.flops)
        rec.bytes_accessed = float(mode.bytes)
        rec.out_bytes = _nbytes(out[1] if not isinstance(out[0], tuple) else out)
        if cuda:
            rec.temp_bytes = max(0, torch.cuda.memory_allocated(device) - mem0
                                 - rec.out_bytes)
            from torch.autograd import DeviceType

            kernels = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
            rec.extra = {"kernels": float(len(kernels)),
                         "device_us": float(sum(e.device_time for e in kernels))}

    def _donor(self, fp: str, key: str) -> Optional[ProgramRecord]:
        """A clean record of the same fingerprint under another key."""
        with self._lock:
            for rec in self._programs.values():
                if rec.fingerprint == fp and rec.key != key and rec.error is None:
                    return rec
        return None

    def _store(self, rec: ProgramRecord) -> None:
        with self._lock:
            prev = self._programs.get(rec.key)
            if prev is not None:
                rec.captures = prev.captures + 1
            self._programs[rec.key] = rec
        self._register_gauges(rec)

    def _register_gauges(self, rec: ProgramRecord) -> None:
        from siddhi_tpu_torch.observability.telemetry import global_registry

        tel = global_registry()
        for metric in self._GAUGE_METRICS:
            # the registry and key, not the record: a re-capture is what
            # the next scrape reads
            tel.gauge(f"jitcost.{rec.key}.{metric}",
                      lambda k=rec.key, m=metric: getattr(
                          self._programs.get(k), m, 0.0) or 0.0)

    # ------------------------------------------------------------ reading

    def programs(self) -> List[ProgramRecord]:
        with self._lock:
            return list(self._programs.values())

    def clusters(self) -> List[dict]:
        """Programs grouped by fingerprint, largest first: a cluster of
        more than one key is one program built more than once."""
        by_fp: Dict[str, List[str]] = {}
        for rec in self.programs():
            by_fp.setdefault(rec.fingerprint, []).append(rec.key)
        return [{"fingerprint": fp, "keys": sorted(keys),
                 "size": len(keys), "duplicates": len(keys) - 1}
                for fp, keys in sorted(by_fp.items(),
                                       key=lambda kv: (-len(kv[1]), kv[0]))]

    def snapshot(self) -> dict:
        """The ``GET /programs`` payload."""
        programs = sorted(self.programs(), key=lambda r: r.key)
        clusters = self.clusters()
        return {
            "enabled": enabled(),
            "programs": [asdict(r) for r in programs],
            "clusters": clusters,
            "unique_fingerprints": len(clusters),
            "duplicate_clusters": sum(1 for c in clusters if c["size"] > 1),
            "duplicate_programs": sum(c["duplicates"] for c in clusters),
        }

    def reset(self) -> None:
        from siddhi_tpu_torch.observability.telemetry import global_registry

        tel = global_registry()
        with self._lock:
            for key in self._programs:
                for metric in self._GAUGE_METRICS:
                    tel.remove_gauge(f"jitcost.{key}.{metric}")
            self._programs.clear()


_REGISTRY = CostRegistry()


def registry() -> CostRegistry:
    return _REGISTRY
