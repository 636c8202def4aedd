"""The port's semantic fuzzer (``siddhi_tpu_torch/fuzz/``) and eligibility
census (``siddhi_tpu_torch/core/eligibility.py``) against the reference's,
on the CPU.

- The nineteen scenarios of ``tests/test_fuzz.py`` run on the port with
  ``device="cpu"``: generator well-formedness and reproducibility, the
  JSON round trip, deterministic windows, the exact order-sensitive
  differ, matrix liveness and the coverage cap, reason codes, the census
  of a keyed time-batch window and of the census-only windows, the
  ``siddhi_eligibility_total`` family, the planted divergence caught and
  shrunk, the clean unplanted matrix and the committed fixtures.
- Differential: ``CaseGenerator(seed).case(i)`` gives the reference's
  JSON and app text byte for byte (seeds 0-2, 100 cases each);
  ``enumerate_matrix`` the reference's labels, collapsed axes and
  ``dropped``; the census the reference's ``(surface, code, detail)``
  rows, but for the port's declared gap (a partitioned keyed-length join
  is ``NOT_PORTED`` on the route surface where the reference routes it);
  the port's baseline rows the reference's (ints, strings and order
  exactly, floats to rtol 1e-12) for six cases with joins, patterns and
  partitions; the planted run's shrunk ``fixture_dict`` the reference's;
  and the committed fixture loads and renders identically in both.
"""

import glob
import json
import math
import os
import pickle

import pytest

from torch_helpers import FLOAT_RTOL, release_jax_programs  # noqa: F401 — autouse fixture

from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.eligibility import (
    SURFACE_FUSION,
    SURFACE_ROUTE,
    Reason,
    ReasonCode,
    code_of,
)
from siddhi_tpu_torch.fuzz.generator import CaseGenerator
from siddhi_tpu_torch.fuzz.runner import (
    BASELINE,
    StrategyCombo,
    audit_census,
    diff_outputs,
    enumerate_matrix,
    run_case,
    run_combo,
)
from siddhi_tpu_torch.fuzz.schema import CaseSpec
from siddhi_tpu_torch.fuzz.shrink import fixture_dict, shrink_case, write_fixture

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "fuzz")
CPU = "cpu"


def _cpu_manager():
    return SiddhiManager(device=CPU)


# ------------------------------------------------------------- generator

def test_generator_wellformedness_100_queries():
    """100 generated queries across the corpus all build on the port."""
    gen = CaseGenerator(seed=11, events_per_case=10)
    total = 0
    i = 0
    while total < 100:
        case = gen.case(i)
        m = _cpu_manager()
        try:
            rt = m.create_siddhi_app_runtime(case.app_text())
            assert rt.eligibility_census   # census registered at build
        finally:
            m.shutdown()
        total += len(case.queries)
        i += 1
    assert total >= 100


def test_generator_seed_reproducibility():
    a = CaseGenerator(seed=7).corpus(5)
    b = CaseGenerator(seed=7).corpus(5)
    assert [c.to_json() for c in a] == [c.to_json() for c in b]
    c = CaseGenerator(seed=8).corpus(5)
    assert [x.to_json() for x in a] != [x.to_json() for x in c]


def test_case_spec_json_roundtrip():
    case = CaseGenerator(seed=3).case(0)
    back = CaseSpec.from_json(case.to_json())
    assert back.app_text() == case.app_text()
    assert back.events == case.events
    assert [q.expect for q in back.queries] == \
        [q.expect for q in case.queries]


def test_generator_windows_are_deterministic():
    from siddhi_tpu_torch.fuzz.determinism import is_deterministic

    for i in range(25):
        case = CaseGenerator(seed=5).case(i)
        for q in case.queries:
            if q.window:
                assert is_deterministic(q.window[0]), q.window
            if q.join:
                for w in (q.join.left_window, q.join.right_window):
                    assert w is None or is_deterministic(w[0]), w


# ---------------------------------------------------------------- differ

def _rows(*pairs):
    return {"Out": [(ts, tuple(vals)) for ts, vals in pairs]}


def test_differ_exact_match_is_clean():
    a = _rows((1, ["x", 2]), (2, ["y", 3]))
    assert diff_outputs(a, _rows((1, ["x", 2]), (2, ["y", 3]))) is None


def test_differ_catches_value_change():
    d = diff_outputs(_rows((1, ["x", 2])), _rows((1, ["x", 3])))
    assert d is not None and d.stream == "Out" and d.index == 0


def test_differ_is_order_sensitive():
    a = _rows((1, ["x", 2]), (2, ["y", 3]))
    b = _rows((2, ["y", 3]), (1, ["x", 2]))
    d = diff_outputs(a, b)
    assert d is not None and d.index == 0


def test_differ_catches_length_mismatch():
    a = _rows((1, ["x", 2]))
    b = _rows((1, ["x", 2]), (2, ["y", 3]))
    d = diff_outputs(a, b)
    assert d is not None and d.index == 1
    assert d.baseline_len == 1 and d.variant_len == 2


def test_differ_float_bits_not_approx():
    d = diff_outputs(_rows((1, [1.0])), _rows((1, [1.0 + 1e-12])))
    assert d is not None, "approximate equality would mask divergence"
    assert diff_outputs(_rows((1, [math.nan])), _rows((1, [math.nan]))) is None


# ---------------------------------------------------------------- matrix

def test_matrix_liveness_collapses_dead_axes():
    case = CaseGenerator(seed=0).case(0)   # join-free, route-ineligible
    assert not any(q.kind == "join" for q in case.queries)
    plan = enumerate_matrix(case)
    assert plan.combos[0] == BASELINE
    assert all(c.join_engine == "legacy" for c in plan.combos)
    assert any("join" in a for a in plan.collapsed_axes)
    # depth and pool axes always live
    assert any(c.depth == 4 for c in plan.combos)
    assert any(c.pool == 2 for c in plan.combos)


def test_matrix_cap_reports_dropped():
    case = CaseGenerator(seed=1).case(1)
    full = enumerate_matrix(case)
    capped = enumerate_matrix(case, max_combos=3)
    if len(full.combos) > 4:
        assert capped.dropped > 0
    assert len(capped.combos) <= 1 + max(
        3, len({v for c in full.combos for v in
                [("depth", c.depth)]}))  # baseline + cap (coverage may pad)


# --------------------------------------------------------- reason codes

def test_reason_is_str_compatible_and_coded():
    r = Reason(ReasonCode.STORE_SIDE, "shared-store side 'T'")
    assert "shared-store" in r             # substring asserts keep working
    assert isinstance(r, str)
    assert r.code is ReasonCode.STORE_SIDE
    assert code_of(r) is ReasonCode.STORE_SIDE
    assert code_of(None) is ReasonCode.ELIGIBLE
    assert code_of("bare legacy text") is ReasonCode.UNKNOWN
    r2 = pickle.loads(pickle.dumps(r))
    assert r2 == r and r2.code is ReasonCode.STORE_SIDE


def test_engine_reasons_carry_codes():
    m = _cpu_manager()
    try:
        rt = m.create_siddhi_app_runtime("""
define stream L (ts long, sym string, lv long);
define stream R (sym string, rv long);
@info(name='j') from L#window.length(4) join R#window.length(4)
  on L.sym == R.sym
  select L.sym as sym, sum(R.rv) as total group by L.sym
  insert into Out;
""")
        q = rt.query_runtimes["j"]
        assert q.engine is not None
        assert code_of(q.engine_reason) is ReasonCode.ELIGIBLE
        assert code_of(q.pipeline_reason) is ReasonCode.GROUPED_SELECT
        assert "grouped selector" in q.pipeline_reason
    finally:
        m.shutdown()


# ----------------------------------------------------------- the census

def test_census_known_ineligible_timebatch_keyed():
    """A keyed (partitioned) time-batch window censuses
    route=WINDOW_NOT_GLOBAL_AWARE (and never UNKNOWN)."""
    m = _cpu_manager()
    try:
        rt = m.create_siddhi_app_runtime("""
define stream S (sym string, v long);
partition with (sym of S)
begin
  @info(name='ktb') from S#window.timeBatch(1 sec)
  select sym, sum(v) as total insert into Out;
end;
""")
        rows = rt.eligibility_census["ktb"]
        by_surface = {s: c for s, c, _d in rows}
        assert by_surface[SURFACE_ROUTE] is ReasonCode.WINDOW_NOT_GLOBAL_AWARE
        assert by_surface[SURFACE_FUSION] is ReasonCode.PARTITIONED
        assert all(c is not ReasonCode.UNKNOWN for c in by_surface.values())
        # counted on the telemetry registry for the /metrics family
        snap = rt.app_context.telemetry.snapshot()
        names = [n for n in snap.get("counters", {})
                 if n.startswith("eligibility.route.")]
        assert any("WINDOW_NOT_GLOBAL_AWARE.ktb" in n for n in names), names
    finally:
        m.shutdown()


def test_census_only_windows_build():
    """CENSUS_ONLY_WINDOWS render to SiddhiQL the port can build."""
    from siddhi_tpu_torch.fuzz.determinism import (
        CENSUS_ONLY_WINDOWS, is_deterministic, window_clause)

    for kind in CENSUS_ONLY_WINDOWS:
        assert not is_deterministic(kind)
        clause = window_clause(kind, 1)
        m = _cpu_manager()
        try:
            rt = m.create_siddhi_app_runtime(
                f"define stream S (sym string, v long);\n"
                f"@info(name='q') from S{clause} "
                f"select sym, v insert into Out;\n")
            assert rt.eligibility_census["q"]
        finally:
            m.shutdown()


def test_census_renders_metrics_family():
    from siddhi_tpu_torch.observability import export

    m = _cpu_manager()
    try:
        m.create_siddhi_app_runtime(
            "define stream S (sym string, v long);\n"
            "@info(name='q') from S select sym, v insert into Out;\n")
        text = export.prometheus_text(m)
        fam = "siddhi_" + "eligibility_total"
        lines = [ln for ln in text.splitlines() if ln.startswith(fam + "{")]
        assert any('surface="route"' in ln and 'code="UNKEYED"' in ln
                   and 'query="q"' in ln for ln in lines), lines
    finally:
        m.shutdown()


# ---------------------------------------- planted divergence + shrinking

def _planted(mod_runner, mod_shrink, gen_cls, **dev):
    case = gen_cls(seed=3, events_per_case=24).case(0)
    res = mod_runner.run_case(case, max_combos=3, plant=True,
                              stop_on_divergence=True, **dev)
    assert res.divergences, "planted skew not caught by the differ"
    combo, diff = res.divergences[0]
    shrunk = mod_shrink.shrink_case(case, combo, diff, plant=True,
                                    max_runs=12, **dev)
    return combo, shrunk


def test_planted_divergence_caught_and_shrunk(tmp_path):
    """The runner's planted skew (duplicate last row of every depth>1
    variant) is caught by the differ and the shrinker converges to a
    <= 3-clause fixture."""
    gen = CaseGenerator(seed=3, events_per_case=24)
    case = gen.case(0)
    res = run_case(case, max_combos=3, plant=True,
                   stop_on_divergence=True, device=CPU)
    assert res.divergences, "planted skew not caught by the differ"
    combo, diff = res.divergences[0]
    assert combo.depth > 1                      # the skewed strategy
    shrunk = shrink_case(case, combo, diff, plant=True, max_runs=36,
                         device=CPU)
    assert shrunk.case.clause_count() <= 3, shrunk.steps
    assert shrunk.diff.kind == "rows"
    path = write_fixture(shrunk.case, shrunk.combo, shrunk.diff,
                         str(tmp_path))
    data = json.loads(open(path).read())
    assert data["format"] == "siddhi-tpu-fuzz-divergence-v1"
    replay = CaseSpec.from_dict(data["case"])
    assert replay.app_text() == data["app"]


def test_unplanted_small_matrix_is_clean():
    """The same case with no skew runs the same mini-matrix with zero
    divergences and a clean census."""
    case = CaseGenerator(seed=3, events_per_case=24).case(0)
    res = run_case(case, max_combos=3, plant=False, device=CPU)
    assert not res.divergences, [
        (c.label(), d.summary()) for c, d in res.divergences]
    assert not res.census_findings, res.census_findings


# ------------------------------------------------------ fixture corpus

def test_committed_fixtures_are_selfconsistent():
    """Every committed divergence fixture loads, re-renders to its stored
    app text, and carries a genuinely diverging first-row record."""
    paths = sorted(glob.glob(os.path.join(FIXTURE_DIR, "divergence_*.json")))
    assert paths, "the committed fixture corpus is empty"
    for p in paths:
        data = json.loads(open(p).read())
        assert data["format"] == "siddhi-tpu-fuzz-divergence-v1"
        case = CaseSpec.from_dict(data["case"])
        assert case.app_text() == data["app"], p
        assert data["clause_count"] == case.clause_count(), p
        d = data["diff"]
        if d["kind"] == "rows":
            assert d["baseline_row"] != d["variant_row"], p


# ======================================================== differential

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generator_json_and_text_equal_the_reference(seed):
    from siddhi_tpu.fuzz.generator import CaseGenerator as RefGenerator

    port, ref = CaseGenerator(seed), RefGenerator(seed)
    for i in range(100):
        a, b = port.case(i), ref.case(i)
        assert a.to_json() == b.to_json(), (seed, i)
        assert a.app_text() == b.app_text(), (seed, i)


def test_matrix_plans_equal_the_reference():
    from siddhi_tpu.fuzz.generator import CaseGenerator as RefGenerator
    from siddhi_tpu.fuzz.runner import enumerate_matrix as ref_matrix

    for seed in (0, 1, 2):
        for i in range(30):
            case = RefGenerator(seed).case(i)
            for cap in (None, 3, 6):
                for ap in (False, True):
                    a = enumerate_matrix(case, max_combos=cap, autopilot=ap)
                    b = ref_matrix(case, max_combos=cap, autopilot=ap)
                    assert [c.label() for c in a.combos] == \
                        [c.label() for c in b.combos], (seed, i, cap, ap)
                    assert a.collapsed_axes == b.collapsed_axes
                    assert a.dropped == b.dropped
                    assert [c.config() for c in a.combos] == \
                        [c.config() for c in b.combos]


def _census_rows(census):
    return {q: [(s, getattr(c, "value", str(c)), d) for s, c, d in rows]
            for q, rows in census.items()}


def _build_census(package, text, join_engine):
    if package == "port":
        from siddhi_tpu_torch import InMemoryConfigManager
        m = _cpu_manager()
    else:
        from siddhi_tpu import SiddhiManager as RefManager
        from siddhi_tpu.core.util.config import InMemoryConfigManager
        m = RefManager()
    try:
        m.set_config_manager(InMemoryConfigManager(
            {"siddhi_tpu.join_engine": join_engine}))
        return _census_rows(m.create_siddhi_app_runtime(text).eligibility_census)
    finally:
        m.shutdown()


@pytest.mark.parametrize("join_engine", ["device", "legacy"])
def test_census_rows_equal_the_reference(join_engine):
    """Census rows of every query of 30 generated apps: the reference's
    surfaces, codes and details, the route rows of case 24's partitioned
    keyed-length join included (it routes in both packages)."""
    routed_joins = 0
    for i in range(30):
        text = CaseGenerator(0).case(i).app_text()
        port = _build_census("port", text, join_engine)
        ref = _build_census("ref", text, join_engine)
        assert port.keys() == ref.keys(), i
        for q in ref:
            assert len(port[q]) == len(ref[q]), (i, q)
            for (ps, pc, pd), (rs, rc, rd) in zip(port[q], ref[q]):
                assert ps == rs, (i, q)
                assert pc != "NOT_PORTED", (i, q, pd)
                assert (pc, pd) == (rc, rd), (i, q, ps)
                if i == 24 and ps == SURFACE_ROUTE:
                    routed_joins += pc == "ELIGIBLE"
    assert routed_joins >= 1      # case 24's partitioned join


def test_not_ported_route_is_a_declared_gap_not_a_finding():
    """The generator expects a partitioned keyed-length join to route, and
    it does: the route row is ELIGIBLE and the audit lists no gap and
    finds nothing. A NOT_PORTED row would still go to the gaps, and a
    code the planner did not declare stays a finding."""
    case = CaseGenerator(0).case(24)
    (q,) = case.queries
    assert q.kind == "join" and q.partition_key
    assert q.expect[SURFACE_ROUTE] == ReasonCode.ELIGIBLE.value
    _out, census, errs = run_combo(case, BASELINE, device=CPU)
    route = [c for s_, c, _d in census["q0"] if s_ == SURFACE_ROUTE]
    assert [getattr(c, "value", c) for c in route] == [ReasonCode.ELIGIBLE.value]
    gaps = []
    assert audit_census(case, census, BASELINE, errs, gaps) == []
    assert gaps == []
    declared = {"q0": [(SURFACE_ROUTE, ReasonCode.NOT_PORTED, "a gap")]}
    gaps = []
    assert audit_census(case, declared, BASELINE, [], gaps) == []
    assert gaps == ["q0/route: a gap"]
    bare = {"q0": [(SURFACE_ROUTE, ReasonCode.UNKNOWN, "free text")]}
    assert audit_census(case, bare, BASELINE, [], [])


def _rows_close(a, b) -> bool:
    if a[0] != b[0] or len(a[1]) != len(b[1]):
        return False
    for x, y in zip(a[1], b[1]):
        if isinstance(x, float) or isinstance(y, float):
            x, y = float(x), float(y)
            if math.isnan(x) and math.isnan(y):
                continue
            if not math.isclose(x, y, rel_tol=FLOAT_RTOL, abs_tol=0.0):
                return False
        elif x != y:
            return False
    return True


# joins (6, 9, 11, 24), patterns (6, 11, 13), partitions (1, 9, 11, 24)
@pytest.mark.parametrize("index", [1, 6, 9, 11, 13, 24])
def test_baseline_rows_equal_the_reference(index):
    from siddhi_tpu.fuzz.runner import BASELINE as REF_BASELINE
    from siddhi_tpu.fuzz.runner import run_combo as ref_run_combo

    case = CaseGenerator(0).case(index)
    port, _c, perr = run_combo(case, BASELINE, device=CPU)
    ref, _rc, rerr = ref_run_combo(case, REF_BASELINE)
    assert perr == rerr == []
    assert port.keys() == ref.keys()
    assert sum(len(v) for v in ref.values()) > 0
    for s in ref:
        assert len(port[s]) == len(ref[s]), (s, len(port[s]), len(ref[s]))
        for i, (a, b) in enumerate(zip(port[s], ref[s])):
            assert _rows_close(a, b), (s, i, a, b)


def test_planted_shrink_equals_the_reference():
    from siddhi_tpu.fuzz import runner as ref_runner
    from siddhi_tpu.fuzz import shrink as ref_shrink
    from siddhi_tpu.fuzz.generator import CaseGenerator as RefGenerator
    from siddhi_tpu_torch.fuzz import runner, shrink

    combo, got = _planted(runner, shrink, CaseGenerator, device=CPU)
    rcombo, want = _planted(ref_runner, ref_shrink, RefGenerator)
    assert combo.label() == rcombo.label()
    assert got.steps == want.steps
    assert json.dumps(fixture_dict(got.case, got.combo, got.diff), sort_keys=True) \
        == json.dumps(ref_shrink.fixture_dict(want.case, want.combo, want.diff),
                      sort_keys=True)
    assert got.case.clause_count() <= 3


def test_committed_fixture_loads_identically_in_both():
    from siddhi_tpu.fuzz.schema import CaseSpec as RefCaseSpec

    paths = sorted(glob.glob(os.path.join(FIXTURE_DIR, "divergence_*.json")))
    assert paths
    for p in paths:
        data = json.loads(open(p).read())
        a, b = CaseSpec.from_dict(data["case"]), RefCaseSpec.from_dict(data["case"])
        assert a.app_text() == b.app_text() == data["app"]
        assert a.to_json() == b.to_json()
        assert a.clause_count() == b.clause_count() == data["clause_count"]
        combo = StrategyCombo(**data["combo"])
        assert combo.depth > 1


def test_cli_quick_on_the_cpu(tmp_path):
    """``python -m siddhi_tpu_torch.fuzz --device cpu --quick``: a clean
    report naming the device, no card, and the wrappers' launch counts."""
    from siddhi_tpu_torch.fuzz.__main__ import main

    path = tmp_path / "report.json"
    assert main(["--device", "cpu", "--quick", "--report", str(path)]) == 0
    rep = json.loads(path.read_text())
    assert rep["device"] == "cpu" and rep["device_name"] is None
    assert rep["cases_run"] == 3 and rep["strategy_pairs_diffed"] > 0
    assert set(rep["kernel_launches"]) == {"distinct_scan", "ring_exchange"}
    assert not rep["divergences"] and not rep["census_findings"]
