"""Strategy-matrix differential runner: one case, every live strategy.

Counterpart of ``siddhi_tpu/fuzz/runner.py``. For one generated
:class:`~siddhi_tpu_torch.fuzz.schema.CaseSpec` this module enumerates
every *live* combination of the engine's execution-strategy knobs —
fan-out fusion on/off x pipeline depth {1,4} x device-routed shard count
{1,2,4} x join engine {legacy, device P=1, device P=8} x ingest pool
{0,2} — runs the same deterministic feed through each, and diffs every
output stream EXACTLY (values and order) against the all-legacy
baseline. The variants are semantically overlapping programs whose
outputs must be interchangeable, bit for bit, within one package on one
device.

Axis liveness: an axis whose knob cannot affect this case is collapsed
to its baseline value instead of multiplying the matrix — shard count
only matters when some query is route-eligible, the join axis only when
the app joins, fusion only when a junction has two-plus single-stream
subscribers (or a device join side can fuse). Collapsed axes and any
coverage-capped combos are REPORTED (``MatrixPlan.dropped``), never
silently skipped.

Each run opens ``SiddhiManager(device)``: the card unless the caller
asks for another device. A combo with shards > 1 re-installs its
route-eligible queries through ``device_route_query_step`` over
``make_mesh(shards, device)``, the logical shards side by side on the
one device (``parallel/mesh.py``), which launches the exchange kernel
once a routed dispatch.

Eligibility census: each run also audits the app's build-time
``eligibility_census`` (core/eligibility.py) — a reason without a stable
code (``UNKNOWN``) or a census code that contradicts the generator's
declared expectation is an *unexplained eligibility fallback*. Those are
findings even when outputs match. A ``NOT_PORTED`` row where the
generator expected ``ELIGIBLE`` is the port's declared gap (the
reference takes that strategy, the port has not ported it yet; the
reason names its ROADMAP item): it is reported in
``CaseResult.declared_gaps``, not as a finding.

Logged errors: a batch a query fails on is logged and dropped by its
junction (``Junction.handle_error``'s LOG branch). Every strategy drops
it alike, so the differ sees no divergence; each run therefore counts
the processing errors its junctions log (a handler on the junction's
logger, ``run_combo(logged=...)``), and a non-zero count is a finding of
the case (``CaseResult.logged_errors``).

Planted-divergence self-test: with ``SIDDHI_TPU_FUZZ_PLANT=1`` (or
``plant=True``) the runner deliberately skews the recorded output of
every pipelined (depth > 1) variant by duplicating its last emitted
row — at the collection layer, not in the engine — proving the differ
catches a real ordering/content skew and the shrinker converges.
"""

from __future__ import annotations

import itertools
import logging
import random
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.core.eligibility import (
    SURFACE_JOIN_ENGINE,
    SURFACE_JOIN_PIPELINE,
    SURFACE_ROUTE,
    ReasonCode,
)
from siddhi_tpu_torch.core.util.knobs import env_knob
from siddhi_tpu_torch.fuzz.schema import CaseSpec, np_dtype

_CHUNK_ROWS = 24          # max rows per send_columns batch
_ROWS_PER_SHARD = 512     # routed exchange per-shard receive quota


def plant_enabled() -> bool:
    """The planted-divergence env flag (a typed read)."""
    return bool(env_knob("SIDDHI_TPU_FUZZ_PLANT", "bool", False))


@dataclass(frozen=True)
class StrategyCombo:
    """One point of the strategy matrix (baseline = all defaults)."""

    fuse: bool = False
    depth: int = 1
    shards: int = 1
    join_engine: str = "legacy"
    join_partitions: int = 1
    pool: int = 0
    autopilot: bool = False

    def label(self) -> str:
        lbl = (f"fuse={int(self.fuse)},depth={self.depth},"
               f"shards={self.shards},join={self.join_engine}"
               f"/{self.join_partitions},pool={self.pool}")
        return lbl + ",ap" if self.autopilot else lbl

    def config(self) -> Dict[str, str]:
        cfg = {
            "siddhi_tpu.fuse_fanout": "true" if self.fuse else "false",
            "siddhi_tpu.pipeline_depth": str(self.depth),
            "siddhi_tpu.join_engine": self.join_engine,
            "siddhi_tpu.join_partitions": str(self.join_partitions),
            "siddhi_tpu.ingest_pool": str(self.pool),
            # small sub-batches so the fuzzer's modest chunks still
            # split across pool workers (>= 2 sub-batch eligibility)
            "siddhi_tpu.ingest_split": "8",
        }
        if self.autopilot:
            # deliberately aggressive cadence: many live actuations per
            # case, every one of which must keep bit-identity with the
            # all-legacy baseline
            cfg.update({
                "siddhi_tpu.autopilot": "on",
                "siddhi_tpu.autopilot_interval_s": "0.05",
                "siddhi_tpu.autopilot_cooldown_s": "0.2",
            })
        return cfg


BASELINE = StrategyCombo()


@dataclass
class MatrixPlan:
    """The enumerated matrix for one case + what was collapsed/capped."""

    combos: List[StrategyCombo]
    collapsed_axes: List[str]
    dropped: int = 0                 # combos removed by the coverage cap


@dataclass
class DiffReport:
    """First observed divergence between baseline and one variant."""

    stream: str
    index: int                       # first diverging row (-1 = lengths)
    baseline_row: Optional[List]
    variant_row: Optional[List]
    baseline_len: int = 0
    variant_len: int = 0
    kind: str = "rows"               # 'rows' | 'error'
    detail: str = ""

    def summary(self) -> str:
        if self.kind == "error":
            return f"{self.stream}: variant run failed: {self.detail}"
        return (f"{self.stream}[{self.index}]: baseline="
                f"{self.baseline_row} variant={self.variant_row} "
                f"(lengths {self.baseline_len} vs {self.variant_len})")


@dataclass
class CaseResult:
    """Outcome of one case across the matrix."""

    combos_run: List[str] = field(default_factory=list)
    pairs_diffed: int = 0
    divergences: List[Tuple[StrategyCombo, DiffReport]] = field(
        default_factory=list)
    census_findings: List[str] = field(default_factory=list)
    # NOT_PORTED rows where the generator expected ELIGIBLE (see the
    # module doc): reported, not findings
    declared_gaps: List[str] = field(default_factory=list)
    # runs whose junctions logged processing errors (dropped batches):
    # findings, one line a run
    logged_errors: List[str] = field(default_factory=list)
    census: Dict[str, List[Tuple[str, str, str]]] = field(
        default_factory=dict)
    # the first device-join-mode run's census (the join surfaces read
    # DISABLED under the legacy baseline; reports want the device view)
    census_device: Optional[Dict] = None
    plan: Optional[MatrixPlan] = None
    baseline: Optional[Dict[str, List[Tuple]]] = None


# ------------------------------------------------------------- matrix

def enumerate_matrix(case: CaseSpec, max_combos: Optional[int] = None,
                     max_shards: int = 4,
                     autopilot: bool = False) -> MatrixPlan:
    """Every live strategy combination for this case (baseline first).

    With ``autopilot=True`` the matrix becomes the autopilot axis: the
    all-legacy baseline plus an autopilot-ON twin of every enumerated
    combo (including the baseline itself) — the closed-loop controller
    actuating live knobs mid-feed must stay bit-identical to the
    untouched baseline run."""
    has_join = any(q.kind == "join" for q in case.queries)
    route_live = any(q.expect.get(SURFACE_ROUTE) == ReasonCode.ELIGIBLE.value
                     for q in case.queries)
    src_counts: Dict[str, int] = {}
    for q in case.queries:
        if q.kind == "single" and not q.partition_key:
            src_counts[q.from_stream] = src_counts.get(q.from_stream, 0) + 1
    fuse_live = has_join or any(v >= 2 for v in src_counts.values())

    collapsed = []
    fuse_axis = [False, True] if fuse_live else [False]
    if not fuse_live:
        collapsed.append("fuse (no junction with >= 2 fusable subscribers)")
    depth_axis = [1, 4]
    shard_axis = [1, 2, 4] if route_live else [1]
    shard_axis = [s for s in shard_axis if s <= max_shards]
    if not route_live:
        collapsed.append("shards (no route-eligible query)")
    join_axis = [("legacy", 1)]
    if has_join:
        join_axis += [("device", 1), ("device", 8)]
    else:
        collapsed.append("join (no join query)")
    pool_axis = [0, 2]

    combos = []
    for fuse, depth, shards, (je, jp), pool in itertools.product(
            fuse_axis, depth_axis, shard_axis, join_axis, pool_axis):
        combos.append(StrategyCombo(fuse=fuse, depth=depth, shards=shards,
                                    join_engine=je, join_partitions=jp,
                                    pool=pool))
    combos = [c for c in combos if c != BASELINE]
    dropped = 0
    if max_combos is not None and len(combos) > max_combos:
        # coverage-preserving deterministic sample: keep at least one
        # combo per (axis, value), fill the rest by seeded shuffle
        rng = random.Random(case.seed ^ len(case.events))
        keep: List[StrategyCombo] = []
        remaining = list(combos)
        rng.shuffle(remaining)

        def covers(c: StrategyCombo):
            return {("fuse", c.fuse), ("depth", c.depth),
                    ("shards", c.shards),
                    ("join", (c.join_engine, c.join_partitions)),
                    ("pool", c.pool)}

        needed = set()
        for c in combos:
            needed |= covers(c)
        covered: set = set()
        for c in remaining:
            if len(keep) >= max_combos and needed <= covered:
                break
            if not (covers(c) <= covered) or len(keep) < max_combos:
                keep.append(c)
                covered |= covers(c)
        dropped = len(combos) - len(keep)
        combos = keep
    if autopilot:
        combos = [replace(c, autopilot=True)
                  for c in [BASELINE] + combos]
    return MatrixPlan(combos=[BASELINE] + combos, collapsed_axes=collapsed,
                      dropped=dropped)


# --------------------------------------------------------------- running

class _Collector:
    __slots__ = ("rows",)

    def __init__(self):
        self.rows: List[Tuple] = []

    def receive(self, events):
        self.rows.extend((e.timestamp, tuple(e.data)) for e in events)


def _chunked_feed(case: CaseSpec):
    """Group the global event sequence into runs of consecutive
    same-stream events (capped), preserving cross-stream order."""
    chunks: List[Tuple[str, List[List]]] = []
    for stream, ts, row in case.events:
        if chunks and chunks[-1][0] == stream \
                and len(chunks[-1][1]) < _CHUNK_ROWS:
            chunks[-1][1].append([ts, row])
        else:
            chunks.append((stream, [[ts, row]]))
    return chunks


def _chunk_columns(case: CaseSpec, stream: str, rows):
    spec = case.stream(stream)
    ts = np.array([r[0] for r in rows], dtype=np.int64)
    data = {}
    for j, (attr, atype) in enumerate(spec.attrs):
        data[attr] = np.array([r[1][j] for r in rows], dtype=np_dtype(atype))
    return data, ts


class _LoggedErrors(logging.Handler):
    """Collects the processing errors a junction logs while attached
    (``Junction.handle_error``: the batch is logged and dropped)."""

    def __init__(self, sink: List[str]):
        super().__init__(logging.ERROR)
        self.sink = sink

    def emit(self, record):
        if str(record.msg).startswith("error processing events"):
            self.sink.append(record.getMessage().split("\n", 1)[0])


def run_combo(case: CaseSpec, combo: StrategyCombo, plant: bool = False,
              device=None, logged: Optional[List[str]] = None
              ) -> Tuple[Dict[str, List[Tuple]], Dict, List[str]]:
    """Run the case's feed under one strategy combo on ``device`` (None:
    the card). Returns ``(outputs, census, install_errors)``; ``logged``,
    when given, receives one line for each processing error a junction
    logged in the run."""
    from siddhi_tpu_torch.core.manager import SiddhiManager
    from siddhi_tpu_torch.core.stream.output.stream_callback import StreamCallback
    from siddhi_tpu_torch.core.util.config import InMemoryConfigManager

    class _CB(StreamCallback):
        def __init__(self, sink: _Collector):
            super().__init__()
            self._sink = sink

        def receive(self, events):
            self._sink.receive(events)

    m = SiddhiManager(device)
    install_errors: List[str] = []
    junction_log = logging.getLogger("siddhi_tpu_torch.core.stream.junction")
    counter = _LoggedErrors(logged if logged is not None else [])
    junction_log.addHandler(counter)
    try:
        m.set_config_manager(InMemoryConfigManager(combo.config()))
        rt = m.create_siddhi_app_runtime(case.app_text())
        sinks = {s: _Collector() for s in case.out_streams()}
        for s, c in sinks.items():
            rt.add_callback(s, _CB(c))
        rt.start()
        census = dict(rt.eligibility_census)
        if combo.shards > 1:
            from siddhi_tpu_torch.parallel.mesh import (
                device_route_query_step, make_mesh, route_ineligibility)

            for q in rt.query_runtimes.values():
                if route_ineligibility(q) is None:
                    try:
                        device_route_query_step(
                            q, make_mesh(combo.shards, m.device),
                            rows_per_shard=_ROWS_PER_SHARD)
                    except Exception as e:   # install failure = finding
                        install_errors.append(
                            f"device_route_query_step({q.name}, "
                            f"n={combo.shards}) failed: {e}")
        handlers = {s.name: rt.get_input_handler(s.name)
                    for s in case.streams}
        for stream, rows in _chunked_feed(case):
            data, ts = _chunk_columns(case, stream, rows)
            handlers[stream].send_columns(data, timestamps=ts)
        outputs = {s: list(c.rows) for s, c in sinks.items()}
    finally:
        try:
            m.shutdown()
        finally:
            junction_log.removeHandler(counter)
    if plant and combo.depth > 1:
        # the planted skew: duplicate the last emitted row of the first
        # non-empty stream — injected at the COLLECTION layer so the
        # engine stays untouched while differ + shrinker prove they
        # catch a real content/order divergence
        for s in case.out_streams():
            if outputs.get(s):
                outputs[s] = outputs[s] + [outputs[s][-1]]
                break
    return outputs, census, install_errors


def run_cluster_case(case: CaseSpec, cluster, name: str
                     ) -> Dict[str, List[Tuple]]:
    """Run the case's feed through a live ``ClusterRuntime``
    (cluster/router.py; its workers run on the device it was given) and
    return outputs shaped like ``run_combo``'s.

    Placement is PINNED (no partition keys): the whole app lands on
    ``crc32(name) % n`` — exact for ANY generated app, because the one
    owning worker receives the IDENTICAL ``send_columns`` sequence the
    in-process baseline makes (same ``_chunked_feed`` chunks), so even
    batch-association-sensitive float accumulations must match bit for
    bit after the wire round-trip and the ordered egress re-merge."""
    cluster.deploy(case.app_text(), name=name, sinks=case.out_streams())
    for stream, rows in _chunked_feed(case):
        data, ts = _chunk_columns(case, stream, rows)
        cluster.send_columns(name, stream, data, timestamps=ts)
    if not cluster.quiesce(120):
        raise RuntimeError(f"cluster egress never quiesced for {name}")
    return {s: [(ts_, tuple(vals)) for ts_, vals in
                cluster.egress.stream_rows(name, s)]
            for s in case.out_streams()}


def diff_outputs(base: Dict[str, List[Tuple]],
                 variant: Dict[str, List[Tuple]]) -> Optional[DiffReport]:
    """Exact, order-sensitive diff. Returns the FIRST divergence."""
    for stream in base:
        b, v = base[stream], variant.get(stream, [])
        n = min(len(b), len(v))
        for i in range(n):
            if not _rows_equal(b[i], v[i]):
                return DiffReport(stream=stream, index=i,
                                  baseline_row=_jsonable(b[i]),
                                  variant_row=_jsonable(v[i]),
                                  baseline_len=len(b), variant_len=len(v))
        if len(b) != len(v):
            i = n
            return DiffReport(
                stream=stream, index=i,
                baseline_row=_jsonable(b[i]) if i < len(b) else None,
                variant_row=_jsonable(v[i]) if i < len(v) else None,
                baseline_len=len(b), variant_len=len(v))
    return None


def _rows_equal(a: Tuple, b: Tuple) -> bool:
    if a[0] != b[0] or len(a[1]) != len(b[1]):
        return False
    for x, y in zip(a[1], b[1]):
        if isinstance(x, float) and isinstance(y, float):
            # exact bit comparison on purpose (NaN == NaN holds): the
            # strategies promise BIT-identity, not approximate equality
            if np.isnan(x) and np.isnan(y):
                continue
            if x != y:
                return False
        elif x != y:
            return False
    return True


def _jsonable(row: Optional[Tuple]) -> Optional[List]:
    if row is None:
        return None
    ts, data = row
    return [int(ts), [v.item() if isinstance(v, np.generic)
                      else v for v in data]]


# ---------------------------------------------------------------- census

def _code_value(code) -> str:
    return code.value if isinstance(code, ReasonCode) else str(code)


def audit_census(case: CaseSpec, census: Dict, combo: StrategyCombo,
                 install_errors: List[str],
                 gaps: Optional[List[str]] = None) -> List[str]:
    """Unexplained-fallback audit of one run's build-time census. A
    ``NOT_PORTED`` row where the generator expected ``ELIGIBLE`` goes to
    ``gaps`` (when given) instead of the findings."""
    findings = list(install_errors)
    for qname, rows in census.items():
        for surface, code, detail in rows:
            if _code_value(code) == ReasonCode.UNKNOWN.value:
                findings.append(
                    f"{qname}/{surface}: reason without a stable code "
                    f"(free text: {detail!r}) — declare it in "
                    f"core/eligibility.py")
    for q in case.queries:
        rows = census.get(q.name)
        if rows is None:
            # partitioned queries may register under decorated names;
            # expectation auditing only covers exact-name runtimes
            continue
        by_surface: Dict[str, List[str]] = {}
        details: Dict[str, List[str]] = {}
        for surface, code, detail in rows:
            by_surface.setdefault(surface, []).append(_code_value(code))
            details.setdefault(surface, []).append(detail)
        for surface, expected in q.expect.items():
            if surface in (SURFACE_JOIN_ENGINE, SURFACE_JOIN_PIPELINE) \
                    and combo.join_engine != "device":
                continue  # legacy mode rewrites these to DISABLED
            got = by_surface.get(surface)
            if got is None:
                continue
            if expected in got:
                continue
            if (expected == ReasonCode.ELIGIBLE.value
                    and got == [ReasonCode.NOT_PORTED.value]):
                if gaps is not None:
                    gaps.append(f"{q.name}/{surface}: {details[surface][0]}")
                continue
            findings.append(
                f"{q.name}/{surface}: generator expected "
                f"{expected}, engine classified {got} — silent "
                f"strategy fallback or stale expectation")
    return findings


# ------------------------------------------------------------- case loop

def run_case(case: CaseSpec, max_combos: Optional[int] = None,
             max_shards: int = 4, plant: Optional[bool] = None,
             stop_on_divergence: bool = False,
             deadline: Optional[float] = None,
             autopilot: bool = False, device=None) -> CaseResult:
    """Run the whole matrix for one case on ``device`` (None: the card)
    and diff every variant against the baseline. ``deadline``
    (``time.monotonic()`` value) aborts the REMAINING combos cleanly once
    passed — truncation is visible as a shorter ``combos_run`` than the
    plan, never a hang past the caller's budget."""
    import time as _time

    if plant is None:
        plant = plant_enabled()
    plan = enumerate_matrix(case, max_combos=max_combos,
                            max_shards=max_shards, autopilot=autopilot)
    result = CaseResult(plan=plan)

    def note_logged(combo, lines):
        if lines:
            result.logged_errors.append(
                f"{combo.label()}: {len(lines)} processing error(s) logged, "
                f"the first: {lines[0]}")

    logged: List[str] = []
    base_out, base_census, base_errs = run_combo(
        case, plan.combos[0], plant=plant, device=device, logged=logged)
    note_logged(plan.combos[0], logged)
    result.baseline = base_out
    result.combos_run.append(plan.combos[0].label())
    result.census = base_census
    result.census_findings.extend(audit_census(
        case, base_census, plan.combos[0], base_errs, result.declared_gaps))
    for combo in plan.combos[1:]:
        if deadline is not None and _time.monotonic() > deadline:
            break
        logged = []
        try:
            out, census, errs = run_combo(case, combo, plant=plant,
                                          device=device, logged=logged)
        except Exception as e:
            result.combos_run.append(combo.label())
            result.pairs_diffed += 1
            result.divergences.append((combo, DiffReport(
                stream="*", index=-1, baseline_row=None, variant_row=None,
                kind="error", detail=f"{type(e).__name__}: {e}")))
            if stop_on_divergence:
                return result
            continue
        result.combos_run.append(combo.label())
        result.pairs_diffed += 1
        note_logged(combo, logged)
        if combo.join_engine == "device" and result.census_device is None:
            result.census_device = census
        gaps: List[str] = []
        for f in audit_census(case, census, combo, errs, gaps):
            if f not in result.census_findings:   # dedupe across combos
                result.census_findings.append(f)
        for g in gaps:
            if g not in result.declared_gaps:
                result.declared_gaps.append(g)
        d = diff_outputs(base_out, out)
        if d is not None:
            result.divergences.append((combo, d))
            if stop_on_divergence:
                return result
    return result
