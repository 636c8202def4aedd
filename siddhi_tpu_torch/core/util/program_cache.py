"""Process-global program cache: N apps, one step program, one capture.

Counterpart of ``siddhi_tpu/core/util/program_cache.py``. Every code
path of the port that makes a step hands it to the one choke point they
share, ``observability.telemetry.InstrumentedJit``; at its first call a step
that declares a ``family`` and is capturable asks this registry whether
another app already built an equal program. An equal program is shared;
each app's state stays its own.

**The witness** (``make_witness``) is the port's account of "the same
program", the reference's jaxpr text, embedded constants and output tree.
Two steps share an entry only when all of these are equal:

- **family**: the tag of the code that made the step (``query_step``,
  ``fused_fanout``, ``device_routed``, ...): two constructions may run
  equal ops under different wrappers;
- **extra**: a call-site witness for variation within a family (the
  routed layout's shard count, quota and per-shard capacities);
- **device**: a CPU step is not a card step;
- **columns**: the input column spec (``step_graph.column_spec``: every
  input column's name, dtype and shape);
- **state**: every state leaf's (dtype, shape), in order;
- **program**: ``program_signature()`` (the query's AST without its name
  and target, the input definition, the planner's knobs, the stage the
  plan chose, the key capacities, the output names and types);
- **consts**: every constant the step's closure took from app state,
  compared bit for bit (``values_equal``). Today these are the ids the
  app's string dictionary gave the query's string literals at plan time:
  ``sym == 'IBM'`` compiles to ``sym == <id of 'IBM'>``, and two apps'
  dictionaries may give 'IBM' different ids. The reference cannot hit
  this (its jaxpr carries scalar literals inline); a signature that
  renders the literal would share one app's id with another and give
  wrong rows with no error.

Only a step its stages declare capturable may hold an entry (the
``capturable`` flag of the instrument): such a step is a pure device
function of (state, inputs, clock), so whichever app's closure built it
computes every sharer's batch. On the CPU a hit dispatches through the
donor's callable with the app's own state, as the reference shares its
``jax.jit`` callable. On the card the entry also holds the shared CUDA
graphs (``core/query/step_graph.py``, shared mode): captured once over
the entry's own slot state, and every sharer copies its state into the
slot, replays, and copies the slot back, under the entry's lock. So a
hit captures nothing, and neither does a restore of a sharer's state.

Refcounting is per owner and identity-pinned: the owner token is the
app's ``TelemetryRegistry`` instance, unique per runtime, so a blue/green
replace's old runtime can never release the new runtime's refs.
``SiddhiAppRuntime.shutdown`` calls ``release_owner``; an entry at
refcount zero is evicted and its graphs and slot are freed. Departure: an
instrument that is dropped (its runtime rebuilt its step after a capacity
growth, or a restore) releases its one ref at once (``release``), where
the reference keeps the ref until the app shuts down: an entry here holds
a slot of state and graph pools, which a compiled executable does not.
``program_cache_max`` caps live entries: zero-ref entries are evicted
oldest first, and once the cache is full of live entries a new step runs
privately, uncached.

Knobs (``core/util/knobs.py``): ``siddhi_tpu.program_cache`` (bool,
default on) gates an app's participation; ``siddhi_tpu.program_cache_max``
(int, default 256) caps the entries. Process defaults:
``SIDDHI_TPU_PROGRAM_CACHE`` and ``SIDDHI_TPU_PROGRAM_CACHE_MAX``.

Telemetry: the ``program_cache.{hits,misses,evictions}`` counters and the
``program_cache.size`` gauge on the process registry (rendered as the
``siddhi_program_cache_*`` families; ``drain()`` removes the gauge).
``GET /programs`` serves ``cache().snapshot()`` beside the cost
registry's clusters.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


def values_equal(x, y) -> bool:
    """Bit-equality of two array-likes (shape, dtype, every element;
    ``equal_nan`` floats). Unequal on any doubt."""
    try:
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if np.issubdtype(x.dtype, np.floating):
            return bool(np.array_equal(x, y, equal_nan=True))
        return bool(np.array_equal(x, y))
    except Exception:  # noqa: BLE001 — unequal on any doubt
        return False


class Witness:
    """The parts of a step's identity (see the module doc); ``consts`` are
    compared bit for bit, the rest with ``==``."""

    __slots__ = ("family", "extra", "device", "columns", "state", "program",
                 "consts")

    def __init__(self, family, extra, device, columns, state, program, consts):
        self.family = family
        self.extra = extra
        self.device = device
        self.columns = columns
        self.state = state
        self.program = program
        self.consts = tuple(consts)

    def fingerprint(self) -> str:
        """sha1[:16] of the whole witness: the cost registry's cluster key."""
        text = repr((self.family, self.extra, self.device, self.columns,
                     self.state, self.program,
                     tuple(np.asarray(c).tobytes() for c in self.consts)))
        return hashlib.sha1(text.encode()).hexdigest()[:16]

    def matches(self, other: "Witness") -> bool:
        if (self.family, self.extra, self.device, self.columns, self.state,
                self.program) != (other.family, other.extra, other.device,
                                  other.columns, other.state, other.program):
            return False
        if len(self.consts) != len(other.consts):
            return False
        return all(values_equal(a, b) for a, b in zip(self.consts, other.consts))


def make_witness(family: str, extra: str, device, columns, state_leaves,
                 program, consts) -> Witness:
    """``state_leaves``: the step's state tensors in order (their dtype
    and shape enter the witness); ``columns``: ``column_spec`` of the
    first call's inputs."""
    state = tuple((str(t.dtype), tuple(t.shape)) for t in state_leaves)
    return Witness(family, extra, str(device), columns, state, program, consts)


class CacheEntry:
    """One shared step program: ``fn`` is the callable every sharer
    dispatches through, ``graph`` the shared CUDA graphs on the card (None
    on the CPU), ``refs`` maps owner tokens (identity-pinned) to their
    acquire counts."""

    def __init__(self, fingerprint: str, witness: Witness, fn, graph):
        self.fingerprint = fingerprint
        self.witness = witness
        self.fn = fn
        self.graph = graph
        self.refs: Dict[object, int] = {}
        self.hits = 0
        self.keys: set = set()
        self.seq = 0

    @property
    def family(self) -> str:
        return self.witness.family

    def refcount(self) -> int:
        return sum(self.refs.values())

    def shared_by(self) -> List[str]:
        """App names holding refs (a token without a bound name reports as
        ``<process>``)."""
        return sorted({getattr(tok, "owner_name", "") or "<process>"
                       for tok in self.refs})

    def free(self) -> None:
        """Drop the entry's graphs and slot (its refcount reached zero)."""
        if self.graph is not None:
            self.graph.close()
            self.graph = None
        self.fn = None


class ProgramCache:
    """The process-global registry (module singleton via ``cache()``)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._by_fp: Dict[str, List[CacheEntry]] = {}
        self._seq = 0
        self._gauge_on = False

    # ------------------------------------------------------------- attach

    def attach(self, key: str, fn, witness: Witness, owner,
               max_entries: Optional[int] = None,
               make_graph=None) -> Tuple[object, Optional[CacheEntry], bool]:
        """First-call hook: look the witness up, and either share an equal
        entry or register this step. ``make_graph`` (on the card) makes a
        new entry's shared graph. Returns ``(fn, entry, hit)``: ``fn`` is
        what the caller dispatches through from now on, ``entry`` None
        when the step runs privately (the cap is full of live entries)."""
        from siddhi_tpu_torch.observability.telemetry import global_registry

        tel = global_registry()
        fp = witness.fingerprint()
        with self._lock:
            self._seq += 1
            for entry in self._by_fp.get(fp, ()):
                if entry.witness.matches(witness):
                    entry.refs[owner] = entry.refs.get(owner, 0) + 1
                    entry.keys.add(key)
                    entry.hits += 1
                    entry.seq = self._seq
                    tel.count("program_cache.hits")
                    return entry.fn, entry, True
            tel.count("program_cache.misses")
            if max_entries is not None and max_entries >= 0:
                # a cap of zero caches nothing; the cap never evicts an
                # entry that still has a ref
                if self._size_locked() >= max_entries:
                    self._evict_unreferenced_locked(tel, down_to=max_entries - 1)
                if self._size_locked() >= max_entries:
                    return fn, None, False     # full of live entries: private
            entry = CacheEntry(fp, witness, fn,
                               make_graph() if make_graph is not None else None)
            entry.refs[owner] = 1
            entry.keys.add(key)
            entry.seq = self._seq
            self._by_fp.setdefault(fp, []).append(entry)
            self._ensure_gauge_locked(tel)
        return fn, entry, False

    # ---------------------------------------------------------- lifecycle

    def release(self, entry: CacheEntry, owner) -> bool:
        """Drop one ref ``owner`` holds on ``entry`` (a dropped step);
        the entry is evicted at refcount zero. Returns True if evicted."""
        from siddhi_tpu_torch.observability.telemetry import global_registry

        with self._lock:
            n = entry.refs.get(owner, 0)
            if n <= 0:
                return False
            if n > 1:
                entry.refs[owner] = n - 1
                return False
            del entry.refs[owner]
            if entry.refs:
                return False
            self._remove_locked(entry)
            global_registry().count("program_cache.evictions")
        entry.free()
        return True

    def release_owner(self, owner) -> int:
        """Drop every ref the owner token holds; entries reaching refcount
        zero are evicted and freed at once. A token that never acquired is
        a no-op. Returns the number of entries evicted."""
        from siddhi_tpu_torch.observability.telemetry import global_registry

        tel = global_registry()
        freed = []
        with self._lock:
            for fp in list(self._by_fp):
                kept = []
                for entry in self._by_fp[fp]:
                    entry.refs.pop(owner, None)
                    if entry.refs:
                        kept.append(entry)
                    else:
                        freed.append(entry)
                        tel.count("program_cache.evictions")
                if kept:
                    self._by_fp[fp] = kept
                else:
                    del self._by_fp[fp]
        for entry in freed:
            entry.free()
        return len(freed)

    def _remove_locked(self, entry: CacheEntry) -> None:
        bucket = self._by_fp.get(entry.fingerprint, [])
        if entry in bucket:
            bucket.remove(entry)
            if not bucket:
                del self._by_fp[entry.fingerprint]

    def _evict_unreferenced_locked(self, tel, down_to: int) -> None:
        """Evict zero-ref entries oldest first until at most ``down_to``
        remain (live entries are never evicted by the cap)."""
        dead = sorted((e for entries in self._by_fp.values()
                       for e in entries if not e.refs), key=lambda e: e.seq)
        for entry in dead:
            if self._size_locked() <= down_to:
                break
            self._remove_locked(entry)
            entry.free()
            tel.count("program_cache.evictions")

    def _size_locked(self) -> int:
        return sum(len(v) for v in self._by_fp.values())

    def size(self) -> int:
        with self._lock:
            return self._size_locked()

    def entries(self) -> List[CacheEntry]:
        with self._lock:
            return [e for v in self._by_fp.values() for e in v]

    def _ensure_gauge_locked(self, tel) -> None:
        if not self._gauge_on:
            tel.gauge("program_cache.size", self.size)
            self._gauge_on = True

    def drain(self) -> int:
        """Evict and free everything and unregister the size gauge (a tool
        and test hook: live apps re-register at their next first call)."""
        from siddhi_tpu_torch.observability.telemetry import global_registry

        tel = global_registry()
        with self._lock:
            freed = [e for v in self._by_fp.values() for e in v]
            for _ in freed:
                tel.count("program_cache.evictions")
            self._by_fp.clear()
            if self._gauge_on:
                tel.remove_gauge("program_cache.size")
                self._gauge_on = False
        for entry in freed:
            entry.free()
        return len(freed)

    # ------------------------------------------------------------ reading

    def snapshot(self) -> dict:
        """The ``GET /programs`` cache section: every live entry with its
        sharers and, on the card, its graphs, plus the counter roll-up."""
        from siddhi_tpu_torch.observability.telemetry import global_registry

        with self._lock:
            entries = [e for v in self._by_fp.values() for e in v]
            rows = []
            for e in sorted(entries, key=lambda e: (-e.hits, e.fingerprint)):
                g = e.graph
                rows.append({
                    "fingerprint": e.fingerprint,
                    "family": e.family,
                    "platform": e.witness.device,
                    "keys": sorted(e.keys),
                    "shared_by": e.shared_by(),
                    "refcount": e.refcount(),
                    "hits": e.hits,
                    "captured": g is not None,
                    "graphs": g.graph_count if g is not None else 0,
                    "captures": g.captures if g is not None else 0,
                    "replays": g.replays if g is not None else 0,
                    "pool_bytes": g.pool_bytes if g is not None else 0,
                    "slot_bytes": g.slot_bytes if g is not None else 0,
                })
        counters = global_registry().snapshot().get("counters", {})
        return {
            "entries": rows,
            "size": len(rows),
            "hits": counters.get("program_cache.hits", 0),
            "misses": counters.get("program_cache.misses", 0),
            "evictions": counters.get("program_cache.evictions", 0),
        }


def enabled_for(app_context) -> bool:
    """Does this app take part? The per-app knob when a context is bound;
    the env process default otherwise."""
    if app_context is not None:
        return bool(getattr(app_context, "program_cache", True))
    from siddhi_tpu_torch.core.util.knobs import env_knob

    return bool(env_knob("SIDDHI_TPU_PROGRAM_CACHE", "bool", True))


def max_entries_for(app_context) -> int:
    if app_context is not None:
        return int(getattr(app_context, "program_cache_max", 256))
    from siddhi_tpu_torch.core.util.knobs import env_knob

    return int(env_knob("SIDDHI_TPU_PROGRAM_CACHE_MAX", "int", 256))


_CACHE = ProgramCache()


def cache() -> ProgramCache:
    return _CACHE
