"""The harness on the CPU: seeded traffic, parts found by name, the metric
arithmetic on a canned trace, the import rules, and one short cell on the
card where there is one."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import harness
from portbench.generator import Traffic
from portbench.spec import Spec
from portbench.trace import TraceRecord, breakdown

ROOT = Path(__file__).resolve().parents[2]


# ------------------------------------------------------------ traffic

@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, -3, 2**70])
@pytest.mark.parametrize("dist", [{"dist": "keys_uniform"},
                                  {"dist": "keys_zipf", "exponent": 1.2}])
def test_traffic_repeats_by_seed(tiny_spec, seed, dist):
    config = tiny_spec.config("stock_part_l1000_r4")
    mix = dict(tiny_spec.mix("uniform"))
    mix["streams"] = {"StockStream": dict(mix["streams"]["StockStream"], symbol=dist)}
    a, b, c = (Traffic(config, mix, s) for s in (seed, seed, seed + 1))
    for g in (0, 3, 17):
        for col in config["inputs"]["StockStream"]:
            np.testing.assert_array_equal(a.columns(g)[col], b.columns(g)[col])
        assert a.columns(g)["symbol"].dtype == object
        np.testing.assert_array_equal(a.timestamps(g), b.timestamps(g))
    assert not np.array_equal(a.raw(0)["price"], c.raw(0)["price"])
    # every seed the same sizes and value ranges
    raw = a.raw(1)
    assert raw["price"].dtype == np.float32 and raw["volume"].dtype == np.int64
    assert raw["symbol"].min() >= 0 and raw["symbol"].max() < a.n_keys
    assert raw["volume"].min() >= 1 and raw["volume"].max() < 1000
    assert raw["price"].min() >= 0 and raw["price"].max() < 100


def test_pool_cycles_with_rising_timestamps(tiny_spec):
    config = tiny_spec.config("stock_distinct_l10000")
    t = Traffic(config, tiny_spec.mix("uniform"), 1)
    P, B = t.pool_batches, t.batch
    np.testing.assert_array_equal(t.raw(1)["symbol"], t.raw(1 + P)["symbol"])
    assert t.timestamps(1 + P)[0] == (1 + P) * B


# ------------------------------------------------------ found by name

DUMMY_CONFIG = "dummy_cfg"
DUMMY_MIX = "dummy_mix"
DUMMY_CELL = "dummy.cell"
DUMMY_METRIC = "dummy_batches"
DUMMY_E2E = "dummy_sends"


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _add(root: Path, config: dict, reference: str, mix: dict, metrics=(),
         cell=DUMMY_CELL):
    """A configuration, its reference, a mix, metrics and a cell as new
    files and new entries of ``root``'s BENCHMARK.json."""
    pb = root / "portbench"
    (pb / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    (pb / "reference" / f"{config['name']}.py").write_text(reference)
    (pb / "traffic" / f"{DUMMY_MIX}.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": config["name"], "source": "https://example.org/x",
                             "file": f"portbench/configs/{config['name']}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": cell, "config": config["name"],
                               "traffic": DUMMY_MIX, "chips": 1, "why": "a test"})
    for kind, entry, code in metrics:
        (pb / "metrics" / f"{entry['name']}.py").write_text(code)
        bench[kind].append(entry)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_parts_are_new_files_and_entries(tiny_root, tmp_path, cpu):
    """A configuration, a mix, a deployment, an end-to-end and a per-layer
    metric and a cell added as new files and new entries of BENCHMARK.json
    run, with no file that was there edited."""
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    before = _digests(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "stock_distinct_l10000.json").read_text())
    cfg.update(name=DUMMY_CONFIG, deployment="dummy_single")
    (pb / "deployments" / "dummy_single.py").write_text(
        "from portbench.deployments.single import deploy  # noqa: F401\n")
    mix = json.loads((pb / "traffic" / "uniform.json").read_text())
    mix["streams"]["StockStream"]["symbol"] = {"dist": "keys_zipf", "exponent": 1.1}
    _add(root, cfg, (pb / "reference" / "stock_distinct_l10000.py").read_text(), mix, [
        ("per_layer", {"name": DUMMY_METRIC, "unit": "batches", "better": "higher",
                       "source": "program_counter", "layer": "test",
                       "moves": "events_per_s", "workloads": [DUMMY_CELL]},
         "def read(rec):\n    return float(rec.batches)\n"),
        ("end_to_end", {"name": DUMMY_E2E, "unit": "sends", "better": "higher",
                        "bound": 0.25, "source": "host_clock", "workloads": [DUMMY_CELL]},
         "def read(run):\n    return float(run.attempted)\n")])
    after = _digests(root)
    changed = [k for k in before if after.get(k) != before[k]]
    assert changed == ["BENCHMARK.json"]

    spec = Spec(root)
    run = harness.run_cell(spec, DUMMY_CELL, 5, 0.3, True, cpu, 0.0)
    checks = harness.judge(spec, run)
    line = harness.result_line(spec, DUMMY_CELL, run, checks, True, cpu)
    assert line["correct"], line["checks"]
    assert line["metrics"][DUMMY_METRIC]["value"] == run.attempted
    assert "ingest_ms" not in line["metrics"]     # its list names other cells
    assert list(line)[-1] == "checks"
    e2e = harness.result_line(spec, DUMMY_CELL, run, checks, False, cpu)["metrics"]
    assert set(e2e) == {"events_per_s", "batch_p95_ms", "setup_s", DUMMY_E2E}
    assert e2e[DUMMY_E2E]["value"] == run.attempted
    other = harness.result_line(spec, "distinct.uniform", run, checks, False, cpu)
    assert DUMMY_E2E not in other["metrics"]


# two input streams, and an output whose row count depends on the data
TWO_STREAMS_APP = """@app:name('portbench')
define stream A (symbol string, price float, volume long);
define stream B (symbol string, v long);
@info(name = 'qa')
from A[price > 50.0] select symbol, volume as n insert into OutStream;
@info(name = 'qb')
from B[v > 500] select symbol, v as n insert into OutStream;
"""

TWO_STREAMS_REFERENCE = '''
import numpy as np

LIMITS = {"n_mismatch": 0, "ts_mismatch": 0}


def rows_out(traffic, g, config):
    return None         # depends on the data: compare judges it


def expected(traffic, batches, config):
    out = {}
    for g in batches:
        raw, ts = traffic.raw(g), traffic.timestamps(g)
        if traffic.stream(g) == "A":
            keep, n = raw["price"] > 50.0, raw["volume"]
        else:
            keep, n = raw["v"] > 500, raw["v"]
        out[g] = {"ts": ts[keep], "n": n[keep].astype(np.int64)}
    return out


def compare(want, got):
    bad, ts_bad = 0, 0
    for g, w in want.items():
        b = got.get(g) or {}
        n, ts = b.get("n", np.zeros(0)), b.get("__ts__", np.zeros(0))
        if n.shape != w["n"].shape or ts.shape != w["ts"].shape:
            k = max(n.shape[0], w["n"].shape[0])
            bad, ts_bad = bad + k, ts_bad + k
            continue
        bad += int((n != w["n"]).sum())
        ts_bad += int((ts != w["ts"]).sum())
    return {"n_mismatch": bad, "ts_mismatch": ts_bad}
'''


def two_streams(root: Path):
    config = {"name": "dummy_two", "source": "https://example.org/x", "reduced": [],
              "app": TWO_STREAMS_APP,
              "inputs": {"A": {"symbol": "string", "price": "float", "volume": "long"},
                         "B": {"symbol": "string", "v": "long"}},
              "output_stream": "OutStream", "query": "qa",
              "keys": {"column": "symbol", "count": 50, "prefix": "S"},
              "deployment": "single", "fill_batches": 0}
    mix = {"batch": 128, "pool_batches": 3, "streams": {
        "A": {"symbol": {"dist": "keys_uniform"},
              "price": {"dist": "uniform", "low": 0.0, "high": 100.0},
              "volume": {"dist": "uniform_int", "low": 1, "high": 1000}},
        "B": {"symbol": {"dist": "keys_zipf", "exponent": 1.2},
              "v": {"dist": "uniform_int", "low": 1, "high": 1000}}}}
    _add(root, config, TWO_STREAMS_REFERENCE, mix)


def test_two_streams_and_a_row_count_the_data_sets_are_new_files(tiny_root, tmp_path, cpu):
    """A configuration fed through two input streams, whose output rows a
    batch depend on the data (as a join's or a pattern's do), is a new
    configuration, mix and reference: sends take turns between the mix's
    streams, and the reference, not the harness, says what each must
    deliver."""
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    before = _digests(root)
    two_streams(root)
    after = _digests(root)
    assert [k for k in before if after.get(k) != before[k]] == ["BENCHMARK.json"]

    spec = Spec(root)
    run = harness.run_cell(spec, DUMMY_CELL, 8, 0.3, True, cpu, 0.0)
    assert run.record.rows["A"] > 0 and run.record.rows["B"] > 0
    assert {run.traffic.stream(g) for g in run.outputs} == {"A", "B"}
    lengths = {g: len(out.get("n", ())) for g, out in run.outputs.items()}
    assert 0 < min(lengths.values()) and max(lengths.values()) < 128
    checks = harness.judge(spec, run)
    assert harness.passed(checks) and run.failed == 0, checks

    # a send that delivers one row too many is caught by the reference
    g = next(iter(run.outputs))
    out = dict(run.outputs[g])
    out["n"], out["__ts__"] = np.r_[out["n"], 1], np.r_[out["__ts__"], 1]
    run.outputs[g] = out
    assert not harness.passed(harness.judge(spec, run))


# ------------------------------------------------- metric arithmetic

def canned(device_kind="NVIDIA H100 80GB HBM3"):
    """Two batches of the part cell: spans in us, and the card's work."""
    cfg = json.loads((ROOT / "portbench/configs/stock_part_l1000_r4.json").read_text())
    mix = json.loads((ROOT / "portbench/traffic/uniform.json").read_text())
    spans = []
    for b in range(2):
        t = 1000.0 * b
        spans += [("bench.send", 1, t, t + 900, {}),
                  ("bench.encode", 1, t + 10, t + 110, {}),
                  ("junction.dispatch", 1, t + 120, t + 700, {"stream": "StockStream"}),
                  ("query.step", 1, t + 130, t + 690, {"query": "bench"}),
                  ("bench.drain", 1, t + 700, t + 880, {}),
                  ("junction.dispatch", 1, t + 800, t + 870, {"stream": "OutStream"})]
    device = []
    for b in range(2):
        t = 1000.0 * b
        device += [("void keyed_window_kernel<float>(...)", t + 300, t + 400),
                   ("ring_exchange_cols_kernel(ColTable)", t + 400, t + 410),
                   ("Memcpy DtoH (Device -> Pageable)", t + 405, t + 420),
                   ("void (anonymous namespace)::distinct_scan_hash<true>(ScanArgs, int)",
                    t + 500, t + 600)]
    before = {"route.dispatches": 10.0, "graph.replays": 4.0,
              "hist.shard.exchange_ms.bench.sum": 5.0,
              "hist.shard.exchange_ms.bench.count": 3.0}
    after = {"route.dispatches": 12.0, "graph.replays": 6.0, "batches.replayed": 1.0,
             "hist.shard.exchange_ms.bench.sum": 8.0,
             "hist.shard.exchange_ms.bench.count": 5.0}
    return TraceRecord(config=cfg, device_kind=device_kind, batches=2,
                       rows={"StockStream": 2 * mix["batch"]},
                       window=(0.0, 2000.0), spans=spans, device=device,
                       before=before, after=after)


def read(name, rec):
    return Spec(ROOT).metric_reader(name).read(rec)


def test_metric_arithmetic_on_a_canned_trace():
    rec = canned()
    assert read("ingest_ms", rec) == pytest.approx(0.1)
    # query.step 560 us less nothing nested in it
    assert read("query_step_ms", rec) == pytest.approx(0.56)
    # the drain 180 us less the OutStream dispatch 70 inside it
    assert read("drain_ms", rec) == pytest.approx(0.11)
    assert read("emit_ms", rec) == pytest.approx(0.07)
    assert read("route_prep_ms", rec) == pytest.approx(1.5)
    assert read("route_dispatches", rec) == pytest.approx(1.0)
    assert read("graph_replay_pct", rec) == pytest.approx(50.0)
    # every kernel but the two hand-written ones: 100 us a batch
    assert read("step_device_ms", rec) == pytest.approx(0.1)
    # busy: [300, 420] and [500, 600] a batch = 220 of 1000 us
    assert rec.busy_s() == pytest.approx(440e-6)
    assert read("device_idle_pct", rec) == pytest.approx(78.0)
    # K8: 2 x 65,536 rows x (4 + 4 + 8 + 8 + 4) B x 2 at 3.35 TB/s over 20 us
    k8 = 2 * 65536 * 28 * 2 / 3.35e12 / 20e-6 * 100
    assert read("k8_roofline_pct", rec) == pytest.approx(k8)
    # the distinct scan: 2 x 65,536 x (2 x 4 + 8) B over 200 us
    rec.config = json.loads((ROOT / "portbench/configs/stock_distinct_l10000.json").read_text())
    dist = 2 * 65536 * 16 / 3.35e12 / 200e-6 * 100
    assert read("distinct_roofline_pct", rec) == pytest.approx(dist)


def test_readers_find_nothing_and_say_so():
    rec = canned(device_kind="an unknown card")
    assert read("k8_roofline_pct", rec) is None
    assert read("distinct_roofline_pct", rec) is None
    rec = canned()
    rec.device = [d for d in rec.device if "ring_exchange" not in d[0]]
    assert read("k8_roofline_pct", rec) is None
    rec.before, rec.after = {}, {}
    assert read("route_dispatches", rec) is None
    assert read("route_prep_ms", rec) is None


def test_breakdown_labels_idle_time_by_the_host_span():
    b = breakdown(canned())
    ops = dict(b["device_ops"])
    assert ops["void keyed_window_kernel<float>(...)"] == pytest.approx(200e-6)
    idle = dict(b["idle_gaps"])
    # gaps [0, 300), [420, 500), [600, 1300), [1420, 1500), [1600, 2000) us,
    # each split by the innermost span open at each instant
    assert sum(idle.values()) == pytest.approx(2000e-6 - 440e-6)
    assert idle["query.step"] == pytest.approx(680e-6)
    assert idle["bench.encode"] == pytest.approx(200e-6)
    assert idle["bench.drain"] == pytest.approx(220e-6)
    assert idle["junction.dispatch[OutStream]"] == pytest.approx(140e-6)
    assert idle["junction.dispatch[StockStream]"] == pytest.approx(40e-6)
    assert idle["bench.send"] == pytest.approx(80e-6)
    assert idle["between spans"] == pytest.approx(200e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


# --------------------------------------------------------- imports

def test_a_run_loads_no_jax_and_the_references_none_of_the_port(tiny_root):
    code = f"""
import sys, torch
sys.path.insert(0, {str(ROOT)!r})
torch.set_num_threads(1)
from portbench import harness
from portbench.spec import Spec
spec = Spec({str(tiny_root)!r})
run = harness.run_cell(spec, "part.uniform", 3, 0.2, True, torch.device("cpu"), 0.0)
assert harness.passed(harness.judge(spec, run))
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from portbench.spec import Spec
spec = Spec({str(ROOT)!r})
for c in spec.bench["configs"]:
    spec.reference(c["name"])
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"siddhi_tpu_torch", "siddhi_tpu", "jax", "torch"}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "siddhi_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "siddhi_tpu.core", sys)
    assert harness.forbidden_modules() == ["siddhi_tpu.core"]


LOAD_JAX = "import sys, types\nsys.modules.setdefault('jax', types.ModuleType('jax'))\n"


@pytest.mark.parametrize("where", ["reference", "metric"])
def test_jax_loaded_after_the_window_prints_no_result(tiny_root, tmp_path, where):
    """A reference or a metric reader that loads JAX once the window has
    closed: the run exits 3 and prints no result."""
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "stock_distinct_l10000.json").read_text())
    cfg["name"] = DUMMY_CONFIG
    mix = json.loads((pb / "traffic" / "uniform.json").read_text())
    ref = (pb / "reference" / "stock_distinct_l10000.py").read_text()
    metrics = []
    if where == "reference":
        ref = ref.replace("def compare(want: dict, got: dict) -> dict:\n",
                          "def compare(want: dict, got: dict) -> dict:\n"
                          + "".join("    " + ln + "\n" for ln in LOAD_JAX.splitlines()))
        assert "setdefault('jax'" in ref
    else:
        metrics = [("per_layer", {"name": DUMMY_METRIC, "unit": "batches",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "test", "moves": "events_per_s",
                                  "workloads": [DUMMY_CELL]},
                    "def read(rec):\n" + "".join("    " + ln + "\n"
                                                 for ln in LOAD_JAX.splitlines())
                    + "    return 1.0\n")]
    _add(root, cfg, ref, mix, metrics)
    code = f"""
import sys, torch
sys.path.insert(0, {str(ROOT)!r})
torch.set_num_threads(1)
from portbench import harness, run
from portbench.spec import Spec
spec = Spec({str(root)!r})
cpu = torch.device("cpu")
r = harness.run_cell(spec, {DUMMY_CELL!r}, 4, 0.2, True, cpu, 0.0)
assert not harness.forbidden_modules()
sys.exit(run.finish(spec, {DUMMY_CELL!r}, r, True, cpu))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode == 3, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "jax" in out.stderr.splitlines()[-1]


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "part.uniform",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


# ---------------------------------------------------------- the card

@pytest.mark.cuda
def test_one_short_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "distinct.uniform", "--seed", "2147483653", "--seconds", "2",
                          "--trace", "1"], capture_output=True, text=True, timeout=360,
                         cwd=ROOT, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    assert 0 < line["metrics"]["distinct_roofline_pct"]["value"] <= 100


# ---------------------------------------------------- BENCHMARK.json

NAME = r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}"
UNIT = r"[A-Za-z0-9_/%.\-]{1,16}"


def test_benchmark_json_keeps_to_its_shape():
    import re

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and bench["paths"] == ["portbench"]
    spec = Spec(ROOT)
    line = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s  # noqa: E731
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.fullmatch(NAME, c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/") and spec.config(c["name"])["name"] == c["name"]
        assert spec.config(c["name"])["reduced"] == c["reduced"]
        spec.reference(c["name"])
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert re.fullmatch(NAME, w["name"]) and w["chips"] == 1 and line(w["why"])
        spec.mix(w["traffic"])
        e2e = {m["name"] for m in spec.metrics(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics(w["name"], "per_layer")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        spec.metric_reader(m["name"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert re.fullmatch(NAME, m["name"]) and re.fullmatch(UNIT, m["unit"])
        assert m["better"] in ("lower", "higher") and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert set(m.get("workloads", cells)) <= cells
        spec.metric_reader(m["name"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
