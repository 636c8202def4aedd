"""Telemetry registry: gauges, counters and latency histograms.

Counterpart of ``siddhi_tpu/observability/telemetry.py``. Complements
``core/util/statistics.StatisticsManager`` (throughput and latency
trackers behind ``@app:statistics``) with the signals a deployment scrapes
continuously:

- **gauges**: sampled callables (ingest-WAL size, the serving tier's
  admission-pool depth, aggregation bucket and shard counts), registered
  once at wiring time and read at scrape time; a dead probe reports NaN
  instead of failing the scrape;
- **counters**: monotone event counts outside the statistics levels
  (query sheds, shard rebuilds, wire-frame ingest);
- **histograms**: always-on percentile series (aggregation fold latency,
  the serving tier's fan-out, merge and query times).

One registry per app (``SiddhiAppContext.telemetry``, always present) plus
one process-global registry (``global_registry()``) for sites with no app
context; ``export.py`` merges both into every scrape.

- **jit events**: ``record_jit(key, wall_ms, hit)`` per step program,
  fed by ``InstrumentedJit`` (below), the one choke point every step
  path goes through (``instrument_jit``; the inventory is
  ``analysis/step_registry.py``). ``snapshot()["jit"]`` holds ``{key:
  {"compiles", "compile_ms", "hits"}}``.

Departures from the reference's instrument: "compile" is building the
step plus, on the card, capturing its CUDA graph (the reference times
XLA's trace and compile), and the first call's ``span("jit", key=...)``
(``observability/tracing.py``) covers that. The recompile watchdog
(``analysis/sanitize.py``, ``SIDDHI_TPU_SANITIZE=1``) counts the same
compiles: the first build or capture, each later capture (a new column
spec, or a private graph re-bound to replaced state), and, for a
capturable step run eagerly (the CPU's stand-in for its graph) under
sanitize, each new input spec (the shapes and dtypes a graph would be
captured for), which telemetry then records as a compile too. A step
that is not capturable is never captured and compiles once, at its
build; a program-cache hit builds and captures nothing and counts
nothing.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
import weakref
from typing import Callable, Dict

from siddhi_tpu_torch.analysis import sanitize


class InstrumentedJit:
    """First-call proxy around a step callable: the port's counterpart of
    the reference's ``InstrumentedJit`` around a ``jax.jit``.

    At its first call it builds the step's witness
    (``core/util/program_cache.make_witness``), attaches to the
    process-global program cache when the call site declared a
    ``family``, the step is ``capturable`` and the app takes part
    (``siddhi_tpu.program_cache``), captures the step's costs when the
    cost registry is on (``observability/costmodel.py``, on a clone of
    the state, before the call), and records a compile with its wall ms,
    or a hit when an equal program was shared. Later calls count one hit
    each (``count_hits``; a fused group counts its members' instead).

    Two ways to run: ``__call__(state, cols, now)`` runs the step eagerly
    on device columns; ``replay(state, cols, now, depth)`` runs it as a
    CUDA graph (``core/query/step_graph.py``) from host columns: the
    shared entry's graph when the step holds a cache entry, else the
    ``graph`` the call site passed (private, bound to its own state). A
    first replay that captures records the capture's ms as the compile.
    ``close()`` (or dropping the instrument) releases its entry's ref.

    ``program`` (a hashable account of what the step computes, e.g.
    ``QueryRuntime.program_signature()``) and ``consts`` (the constants
    its closure took from app state) enter the witness; a step with no
    program never shares. ``packed``: the step returns ``(state, out)``
    with the meta in ``out["__meta__"]`` (a query step), else ``(outs,
    metas)`` (a fused group's)."""

    def __init__(self, fn: Callable, key: str, telemetry: "TelemetryRegistry",
                 family: str = None, cache_extra: str = "", program=None,
                 consts=(), capturable: bool = False, graph=None,
                 build_ms: float = 0.0, count_hits: bool = True,
                 packed: bool = False):
        self._fn = fn
        self._key = key
        self._telemetry = telemetry
        self._family = family
        self._cache_extra = cache_extra
        self._program = program
        self._consts = tuple(consts)
        self.capturable = capturable
        self.graph = graph          # the graph replays run on
        self._build_ms = build_ms
        self._count_hits = count_hits
        self._packed = packed
        self._compiled = False
        # the recapture watchdog (analysis/sanitize.py): compiles of this
        # step, and under sanitize the eager input specs seen
        self._sanitize = sanitize.enabled()
        self._watch_specs = self._sanitize and capturable
        self._compiles = 0
        self._specs: set = set()
        self.entry = None           # the program-cache entry, when shared
        self.shared = False         # dispatching through another app's program
        self.fingerprint = None
        self._release = None

    @property
    def key(self) -> str:
        return self._key

    def __call__(self, *args, **kwargs):
        if self._compiled:
            if self._watch_specs and self._new_spec(args):
                # an eager capturable step met a new input spec: the
                # capture a graph would make, recorded and then judged as
                # the reference judges a late compile
                t0 = time.perf_counter()
                out = self._fn(*args, **kwargs)
                self._telemetry.record_jit(
                    self._key, wall_ms=(time.perf_counter() - t0) * 1000.0)
                self._note_compile(first=False)
                return out
            if self._count_hits:
                self._telemetry.record_jit(self._key, hit=True)
            return self._fn(*args, **kwargs)
        from siddhi_tpu_torch.observability.tracing import span

        with span("jit", key=self._key):
            self._first(args, graph=False)
            if self._watch_specs:
                self._new_spec(args)
            if not self.shared:
                self._note_compile(first=True)
            t0 = time.perf_counter()
            out = self._fn(*args, **kwargs)
        self._record_first((time.perf_counter() - t0) * 1000.0,
                           built=not self.shared)
        return out

    def replay(self, state, cols, now, depth: int):
        """One batch as a graph replay (a capture when its column spec is
        new). Returns the step's output: ``(state, out)`` for a packed
        step, else ``(outs, metas)``."""
        from siddhi_tpu_torch.core.query import step_graph

        from siddhi_tpu_torch.observability.tracing import span

        first = not self._compiled
        # the first replay's capture is the step's "compile"
        with span("jit", key=self._key) if first else contextlib.nullcontext():
            if first:
                self._first((state, cols, now), graph=True)
            fn = step_graph.packed(self._fn) if self._packed else self._fn
            outs, metas, capture_ms = self.graph.run(
                fn, state, cols, now, depth,
                on_capture=lambda: self._note_compile(first=first))
        if first:
            # a hit whose column spec the entry already holds built nothing
            self._record_first(capture_ms or 0.0,
                               built=not self.shared or capture_ms is not None)
        elif capture_ms is not None:
            # a new column spec (a short batch), or a private graph whose
            # state was replaced: another capture
            self._telemetry.record_jit(self._key, wall_ms=capture_ms)
        elif self._count_hits:
            self._telemetry.record_jit(self._key, hit=True)
        if self._packed:
            out = dict(outs[0])
            out["__meta__"] = metas
            return state, out
        return outs, metas

    def close(self) -> None:
        """Release this step's cache ref (its runtime dropped the step)."""
        if self._release is not None:
            self._release()

    # ----------------------------------------------------------- internals

    def _note_compile(self, first: bool) -> None:
        """One more build or capture of this step: the watchdog judges it
        (a first compile only once compiles are frozen)."""
        self._compiles += 1
        if self._sanitize and (not first or sanitize.compiles_frozen()):
            sanitize.check_recompile(self._key, self._compiles)

    def _new_spec(self, args) -> bool:
        """Record the shapes and dtypes of the call's tensors; True when
        this instrument has not seen them before."""
        from siddhi_tpu_torch.core.query.step_graph import state_leaves

        spec = tuple((tuple(t.shape), t.dtype) for t in state_leaves(args))
        if spec in self._specs:
            return False
        self._specs.add(spec)
        return True

    def _first(self, args, graph: bool) -> None:
        from siddhi_tpu_torch.core.query import step_graph
        from siddhi_tpu_torch.core.util import program_cache
        from siddhi_tpu_torch.observability import costmodel

        state, cols = args[0], args[1] if len(args) > 1 else None
        leaves = step_graph.state_leaves(state)
        device = leaves[0].device if leaves else "cpu"
        program = self._program
        try:
            spec = step_graph.column_spec(cols) if isinstance(cols, dict) else ()
        except TypeError:       # a column no graph input holds: nothing shares
            spec, program = (), None
        witness = program_cache.make_witness(
            self._family, self._cache_extra, device, spec, leaves,
            program if program is not None else ("key", self._key),
            self._consts)
        self.fingerprint = witness.fingerprint()
        ctx = getattr(self._telemetry, "app_context", None)
        if (self._family is not None and self.capturable
                and program is not None and program_cache.enabled_for(ctx)):
            make_graph = None
            if graph:
                def make_graph(dev=self.graph.device if self.graph is not None
                               else device):
                    return step_graph.StepGraph(dev, shared=True)
            fn, entry, hit = program_cache.cache().attach(
                self._key, self._fn, witness, owner=self._telemetry,
                max_entries=program_cache.max_entries_for(ctx),
                make_graph=make_graph)
            if entry is not None:
                self._fn, self.entry, self.shared = fn, entry, hit
                if graph:
                    if entry.graph is None:
                        # the entry was made by an eager caller (a group
                        # told to run eagerly): its graph comes now
                        entry.graph = make_graph()
                    self.graph = entry.graph
                self._release = weakref.finalize(
                    self, program_cache.cache().release, entry, self._telemetry)
        if graph and self.graph is None:
            self.graph = step_graph.StepGraph(device)
        if costmodel.enabled():
            costmodel.registry().capture(self._key, self._fn, args, witness,
                                         shared=self.shared, graph=graph,
                                         packed=self._packed, run=self.capturable)

    def _record_first(self, wall_ms: float, built: bool) -> None:
        self._compiled = True
        if built:
            self._telemetry.record_jit(self._key, wall_ms=self._build_ms + wall_ms)
        else:
            self._telemetry.record_jit(self._key, hit=True)


class TelemetryRegistry:
    def __init__(self):
        # the app this registry belongs to (bound by SiddhiAppContext):
        # the instance is the app's identity-pinned owner token in the
        # program cache, and its context carries the cache's knobs
        self.app_context = None
        self.owner_name = ""
        self._lock = threading.RLock()
        self._gauges: Dict[str, Callable[[], float]] = {}
        self.counters: Dict[str, int] = {}
        # name -> observability.histogram.Histogram (ms by convention)
        self.histograms: Dict[str, object] = {}
        # compiled-step key -> {"compiles", "compile_ms", "hits"}
        self.jit: Dict[str, dict] = {}

    # ------------------------------------------------------------- gauges

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Register (or replace) a sampled gauge."""
        with self._lock:
            self._gauges[name] = fn

    def remove_gauge(self, name: str) -> None:
        with self._lock:
            self._gauges.pop(name, None)

    def read_gauges(self) -> Dict[str, float]:
        with self._lock:
            items = list(self._gauges.items())
        out = {}
        for name, fn in items:
            try:
                out[name] = float(fn())
            except Exception:  # noqa: BLE001 — a dead probe must not
                out[name] = math.nan  # fail the scrape
        return out

    # ----------------------------------------------------------- counters

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # ---------------------------------------------------------- histograms

    def histogram(self, name: str):
        """Get-or-create a named log-bucket latency histogram
        (``observability/histogram.py``). Idempotent: call sites keep the
        returned object and record on it directly."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                from siddhi_tpu_torch.observability.histogram import Histogram

                h = self.histograms[name] = Histogram()
            return h

    # --------------------------------------------------------- jit events

    def record_jit(self, key: str, wall_ms: float = 0.0,
                   hit: bool = False) -> None:
        with self._lock:
            rec = self.jit.get(key)
            if rec is None:
                rec = self.jit[key] = {"compiles": 0, "compile_ms": 0.0,
                                       "hits": 0}
            if hit:
                rec["hits"] += 1
            else:
                rec["compiles"] += 1
                rec["compile_ms"] += float(wall_ms)

    def instrument_jit(self, fn: Callable, key: str, family: str = None,
                       cache_extra: str = "", **kw) -> InstrumentedJit:
        """Wrap a freshly built step so its first call is recorded as a
        compile event. ``family`` (the tag of the code that made it, e.g.
        ``"query_step"``) opts a capturable step into the process-global
        program cache; ``cache_extra`` carries any witness its program
        cannot show (a routed layout). Further keywords: see
        ``InstrumentedJit``."""
        return InstrumentedJit(fn, key, self, family=family,
                               cache_extra=cache_extra, **kw)

    # ------------------------------------------------------------ reading

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            jit = {k: dict(v) for k, v in self.jit.items()}
            hists = {k: h.snapshot() for k, h in self.histograms.items()}
        out = {"gauges": self.read_gauges(), "counters": counters,
               "jit": jit}
        if hists:
            out["histograms"] = hists
        return out

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.jit.clear()
            for h in self.histograms.values():
                h.reset()


_GLOBAL = TelemetryRegistry()


def global_registry() -> TelemetryRegistry:
    """Process-wide registry for sites with no app context (the serving
    tier's admission pool)."""
    return _GLOBAL
