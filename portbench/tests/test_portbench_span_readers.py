"""The readers of the program's own hot-path spans and card-time histogram
(``encode_ms``, ``key_ms``, ``launch_ms``, ``pump_drain_ms``, ``sync_ms``,
``syncs``, ``step_card_ms``) on a synthetic trace, and on one from a
program that records none of them, where each reads nothing."""

import json
from pathlib import Path

import pytest

from portbench.spec import Spec
from portbench.trace import TraceRecord, breakdown

ROOT = Path(__file__).resolve().parents[2]
NEW = ("encode_ms", "key_ms", "launch_ms", "pump_drain_ms", "sync_ms", "syncs",
       "step_card_ms")


def record(own_spans=True):
    """Two batches of the part cell in us: the benchmark's spans and, with
    ``own_spans``, the program's hot-path spans inside them."""
    cfg = json.loads((ROOT / "portbench/configs/stock_part_l1000_r4.json").read_text())
    spans = []
    for b in range(2):
        t = 1000.0 * b
        spans += [("bench.send", 1, t, t + 900, {}),
                  ("bench.encode", 1, t + 10, t + 110, {}),
                  ("junction.dispatch", 1, t + 120, t + 700, {"stream": "StockStream"}),
                  ("query.step", 1, t + 130, t + 690, {"query": "bench"}),
                  ("bench.drain", 1, t + 700, t + 880, {}),
                  ("junction.dispatch", 1, t + 800, t + 870, {"stream": "OutStream"})]
        if own_spans:
            spans += [("input.encode", 1, t + 12, t + 108,
                       {"stream": "StockStream", "rows": 65536}),
                      # an encode of another stream (a timer batch) is not the input's
                      ("input.encode", 1, t + 140, t + 150, {"stream": "OutStream", "rows": 1}),
                      ("query.key", 1, t + 160, t + 260, {"query": "bench"}),
                      # a keyer's read of a re-published batch's device columns
                      ("sync.columns", 1, t + 200, t + 220,
                       {"stream": "StockStream", "columns": 4}),
                      ("route.prep", 1, t + 270, t + 300, {"query": "bench", "pieces": 1}),
                      ("step.launch", 1, t + 300, t + 500, {"query": "bench", "graph": True}),
                      ("sync.staging", 1, t + 310, t + 340, {}),
                      ("pipeline.drain", 1, t + 702, t + 878, {"owner": "bench", "entries": 1}),
                      ("sync.meta", 1, t + 705, t + 795, {"query": "bench"}),
                      ("sync.columns", 1, t + 810, t + 850,
                       {"stream": "OutStream", "columns": 4})]
    before = {"hist.step.card_ms.bench.sum": 100.0, "hist.step.card_ms.bench.count": 9.0}
    after = {"hist.step.card_ms.bench.sum": 112.5, "hist.step.card_ms.bench.count": 11.0}
    if not own_spans:
        before, after = {}, {}
    return TraceRecord(config=cfg, device_kind="NVIDIA H100 80GB HBM3", batches=2,
                       rows={"StockStream": 2 * 65536}, window=(0.0, 2000.0),
                       spans=spans, device=[], before=before, after=after)


def read(name, rec):
    return Spec(ROOT).metric_reader(name).read(rec)


def test_span_readers_on_a_synthetic_trace():
    rec = record()
    assert read("encode_ms", rec) == pytest.approx(0.096)
    # query.key 100 us less the column pull's 20 inside it
    assert read("key_ms", rec) == pytest.approx(0.08)
    # step.launch 200 us less the staging slot's wait 30
    assert read("launch_ms", rec) == pytest.approx(0.17)
    # the drain 176 us less the OutStream dispatch 70 inside it
    assert read("pump_drain_ms", rec) == pytest.approx(0.106)
    assert read("sync_ms", rec) == pytest.approx(0.18)
    assert read("syncs", rec) == pytest.approx(4.0)
    # 12.5 ms over 2 steps in the window's delta, over 2 batches
    assert read("step_card_ms", rec) == pytest.approx(6.25)


def test_span_readers_find_nothing_in_a_program_without_the_spans():
    rec = record(own_spans=False)
    for name in NEW:
        assert read(name, rec) is None, name
    # and the accepted readers still read the benchmark's own spans
    assert read("ingest_ms", rec) == pytest.approx(0.1)
    assert read("drain_ms", rec) == pytest.approx(0.11)


def test_idle_time_splits_under_the_new_spans():
    rec = record()
    rec.device = [("void keyed_window_kernel<float>(...)", 1000.0 * b + 500, 1000.0 * b + 690)
                  for b in range(2)]
    idle = dict(breakdown(rec)["idle_gaps"])
    # the step's host work now lies under its inner spans, the bare
    # query.step label keeps only what none of them covers
    assert idle["query.key"] == pytest.approx(160e-6)
    assert idle["route.prep"] == pytest.approx(60e-6)
    assert idle["step.launch"] == pytest.approx(340e-6)
    assert idle["query.step"] == pytest.approx(60e-6)
    assert idle["sync.meta"] == pytest.approx(180e-6)


def test_the_new_metrics_are_entries_of_both_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == ["part.uniform", "distinct.uniform"]
        assert m["moves"] == "events_per_s" and m["better"] == "lower"
    assert entries["syncs"]["unit"] == "syncs/batch"
    assert entries["step_card_ms"]["source"] == "program_counter"
    assert [m["name"] for m in bench["per_layer"][-len(NEW):]] == list(NEW)
