"""The spans inside the port's hot path (``observability/tracing.py``), the
step's card time (``step.card_ms.<query>``) and the one clock the span
tracer shares with the device profiler.

The apps are the benchmark's two configurations (``portbench/configs/``):
the routed 10k-key partition (here routed x4 at a small size) and the
sliding distinct count, run on the CPU, where each blocking call is
recorded as a ``sync.<site>`` span although it takes no wait. The tests
marked ``cuda`` run the same apps at their real size on the card and hold
the ``sync.*`` spans to the blocking calls ``torch.cuda`` reports.
"""

import json
import time
import types
import warnings
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch

from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager, StreamCallback
from siddhi_tpu_torch.core.query import completion
from siddhi_tpu_torch.core.query import runtime as runtime_mod
from siddhi_tpu_torch.observability import device_trace
from siddhi_tpu_torch.observability.export import prometheus_text
from siddhi_tpu_torch.observability.tracing import NOOP_SPAN, TRACER, Tracer, span
from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {name: json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
           for name in ("stock_part_l1000_r4", "stock_distinct_l10000")}
PART, DISTINCT = CONFIGS["stock_part_l1000_r4"], CONFIGS["stock_distinct_l10000"]
ROWS, KEYS = 64, 20
HOT_SPANS = ("input.encode", "query.key", "route.prep", "step.launch",
             "pipeline.drain", "sync.meta", "sync.columns")


@pytest.fixture(autouse=True)
def _tracer_off():
    TRACER.enabled = False
    TRACER.clear()
    yield
    TRACER.enabled = False


class Sink(StreamCallback):
    """Reads every output batch's columns once, as a consumer does."""

    def __init__(self):
        super().__init__()
        self.rows = 0

    def receive_batch(self, batch, junction):
        self.rows += int(np.asarray(batch.cols["__valid__"]).sum())


def build(cfg, device="cpu", depth=2, window=8):
    """(manager, runtime, query, sink) of a configuration's app: cut to a
    ``window`` and ``ROWS`` rows a shard, or with ``window`` None at the
    configuration's own size (its key slots, value slots and quota)."""
    knobs = {f"siddhi_tpu.{k}": str(v) for k, v in (cfg.get("knobs") or {}).items()}
    knobs["siddhi_tpu.pipeline_depth"] = str(depth)
    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager(knobs))
    app = cfg["app"]
    rows_per_shard = int(cfg.get("route", {}).get("rows_per_shard", 0))
    if window is not None:
        app = app.replace(f"length({cfg['window']})", f"length({window})")
        rows_per_shard = ROWS
    rt = m.create_siddhi_app_runtime(app)
    q = rt.query_runtimes[cfg["query"]]
    if window is None and "key_slots" in cfg:
        q.selector_plan.num_keys = q._win_keys = int(cfg["key_slots"])
    if window is None and "distinct" in cfg:
        for spec in q.selector_plan.specs:
            spec.distinct_capacity = int(cfg["distinct"]["capacity"])
    if "route" in cfg:
        device_route_query_step(q, make_mesh(int(cfg["route"]["shards"]), torch.device(device)),
                                rows_per_shard=rows_per_shard)
    sink = Sink()
    rt.add_callback(cfg["output_stream"], sink)
    return m, rt, q, sink


def send(rt, g, rows=ROWS, keys=KEYS):
    rng = np.random.default_rng(g)
    sym = np.array([f"S{i}" for i in rng.integers(0, keys, rows)], dtype=object)
    rt.get_input_handler("StockStream").send_columns(
        {"symbol": sym, "price": rng.random(rows).astype(np.float32),
         "volume": rng.integers(1, 1000, rows)},
        timestamps=np.arange(g * rows, (g + 1) * rows))


def traced(rt, first, n, **sizes):
    """Sends ``first .. first + n - 1`` under the tracer: the complete events."""
    TRACER.start()
    for g in range(first, first + n):
        send(rt, g, **sizes)
    return [e for e in TRACER.stop()["traceEvents"] if e.get("ph") == "X"]


def parents(events):
    """{id(event): the innermost span enclosing it on its thread, or None}."""
    by_tid = defaultdict(list)
    for e in events:
        by_tid[e["tid"]].append(e)
    out = {}
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            out[id(e)] = stack[-1] if stack else None
            stack.append(e)
    return out


def label(e):
    if e is None:
        return None
    stream = (e.get("args") or {}).get("stream")
    return e["name"] + (f"[{stream}]" if stream and e["name"] == "junction.dispatch" else "")


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("depth", [2, 1])
def test_part_app_records_every_hot_span_with_its_args_and_nesting(depth):
    m, rt, q, sink = build(PART, depth=depth)
    try:
        send(rt, 0)
        n = 3
        evs = traced(rt, 1, n)
    finally:
        m.shutdown()
    up = parents(evs)
    count = Counter(e["name"] for e in evs)
    for name in HOT_SPANS:
        want = 0 if name == "pipeline.drain" and depth == 1 else n
        assert count[name] == want, (name, count)
    where = defaultdict(set)
    for e in evs:
        where[e["name"]].add(label(up[id(e)]))
        args = e.get("args") or {}
        if e["name"] == "input.encode":
            assert args == {"stream": "StockStream", "rows": ROWS}
        elif e["name"] in ("query.key", "sync.meta"):
            assert args == {"query": "bench"}
        elif e["name"] == "route.prep":
            assert args == {"query": "bench", "pieces": 1}
        elif e["name"] == "step.launch":
            assert args == {"query": "bench", "graph": False}
        elif e["name"] == "pipeline.drain":
            assert args == {"owner": "bench", "entries": 1}
        elif e["name"] == "sync.columns":
            assert args["stream"] == "OutStream" and args["columns"] > 0
    for name in ("query.key", "route.prep", "step.launch"):
        assert where[name] == {"query.step"}, (name, where[name])
    # at depth 2 a synchronous send's pipeline drains after the step, at
    # the send's end; at depth 1 the step pulls its meta itself
    assert where["sync.meta"] == {"pipeline.drain" if depth == 2 else "query.step"}
    assert where["sync.columns"] == {"junction.dispatch[OutStream]"}
    assert where["input.encode"] == {None}
    assert sink.rows == (n + 1) * ROWS


def test_distinct_app_keys_and_launches_inside_its_step_and_routes_nothing():
    m, rt, q, sink = build(DISTINCT, window=40)
    try:
        send(rt, 0)
        evs = traced(rt, 1, 2)
    finally:
        m.shutdown()
    up = parents(evs)
    count = Counter(e["name"] for e in evs)
    assert count["route.prep"] == 0 and count["sync.lut"] == 0
    for name in ("input.encode", "query.key", "step.launch", "pipeline.drain",
                 "sync.meta", "sync.columns"):
        assert count[name] == 2, (name, count)
    for e in evs:
        if e["name"] in ("query.key", "step.launch"):
            assert label(up[id(e)]) == "query.step"
    assert sink.rows == 3 * ROWS


def test_tracer_off_records_nothing_and_stages_no_timing_event(monkeypatch):
    timed = []
    stage = runtime_mod.stage_meta

    def spy(meta, timed_event=False):
        timed.append(timed_event)
        return stage(meta, timed_event)

    monkeypatch.setattr(runtime_mod, "stage_meta",
                        lambda meta, timed=False: spy(meta, timed))
    m, rt, q, sink = build(PART)
    try:
        for g in range(3):
            send(rt, g)
        assert len(TRACER) == 0
        hists = rt.app_context.telemetry.snapshot().get("histograms", {})
        assert not any(k.startswith("step.card_ms") for k in hists)
    finally:
        m.shutdown()
    assert timed == [False] * 3
    assert completion.card_timer(torch.device("cuda")) is None
    assert completion.card_timer(torch.device("cpu")) is None


def _fake_torch(made):
    class Event:
        def __init__(self, enable_timing=False):
            made.append(enable_timing)

        def record(self):
            pass

    class Host:
        def copy_(self, src, non_blocking=False):
            assert non_blocking

    return types.SimpleNamespace(empty=lambda *a, **k: Host(),
                                 cuda=types.SimpleNamespace(Event=Event))


def test_stage_meta_times_only_a_traced_step(monkeypatch):
    made = []
    monkeypatch.setattr(completion, "torch", _fake_torch(made))
    card = types.SimpleNamespace(type="cuda")
    meta = types.SimpleNamespace(device=card, shape=(3,), dtype=None)
    completion.stage_meta(meta)
    assert completion.card_timer(card) is None
    assert made == [False]
    TRACER.start()
    try:
        assert completion.card_timer(card) is not None
        completion.stage_meta(meta, timed=True)
    finally:
        TRACER.stop()
    assert made == [False, True, True]


def test_card_time_is_recorded_once_its_end_has_completed():
    class Ev:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

        def elapsed_time(self, end):
            assert end.done
            return 2.5

    m, rt, q, _sink = build(DISTINCT, window=40)
    try:
        completion.record_card_ms(q, Ev(True), Ev(False))
        hists = rt.app_context.telemetry.snapshot().get("histograms", {})
        assert "step.card_ms.bench" not in hists
        completion.record_card_ms(q, Ev(True), Ev(True))
        completion.record_card_ms(q, Ev(True), Ev(True))
        h = rt.app_context.telemetry.snapshot()["histograms"]["step.card_ms.bench"]
        assert h["count"] == 2 and h["sum"] == pytest.approx(5.0)
        assert 'siddhi_step_card_ms_count{app="portbench",query="bench"} 2' in \
            prometheus_text(m).replace(" 2.0", " 2")
    finally:
        m.shutdown()


def test_span_args_set_inside_and_a_noop_when_off():
    t = Tracer(capacity=16)
    with t.span("off") as sp:
        sp.set(n=1)
    assert sp is NOOP_SPAN and len(t) == 0
    t.start()
    with t.span("on", a=1) as sp:
        sp.set(n=2)
    evs = [e for e in t.stop()["traceEvents"] if e.get("ph") == "X"]
    assert [(e["name"], e["args"]) for e in evs] == [("on", {"a": 1, "n": 2})]


def test_tracer_states_its_epoch_on_the_unix_clock():
    t = Tracer(capacity=16)
    before = time.time_ns()
    t.start()
    after = time.time_ns()
    with t.span("s"):
        pass
    trace = t.stop()
    epoch = trace["otherData"]["epoch_unix_ns"]
    assert before <= epoch <= after
    s = next(e for e in trace["traceEvents"] if e.get("ph") == "X")
    assert before <= epoch + s["ts"] * 1000 <= time.time_ns()


def test_spans_and_the_profiler_share_one_clock():
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(4096)
    TRACER.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("clock.mul"):
            x * 2
    trace = TRACER.stop()
    s = next(e for e in trace["traceEvents"] if e.get("name") == "clock.mul")
    lo = trace["otherData"]["epoch_unix_ns"] + s["ts"] * 1000
    hi = lo + s["dur"] * 1000
    mul = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mul"]
    assert len(mul) == 1
    assert lo - 1e6 <= mul[0].start_ns() and mul[0].end_ns() <= hi + 1e6


@pytest.mark.parametrize("with_spans", [True, False])
def test_device_trace_file_holds_the_spans_on_its_time_base(tmp_path, with_spans):
    x = torch.ones(4096)
    TRACER.start()
    with span("before.trace"):     # outside the trace's interval: left out
        x * 3
    if not with_spans:
        TRACER.stop()
        TRACER.clear()
    device_trace.start(str(tmp_path))
    try:
        with span("clock.mul", n=1):
            x * 2
    finally:
        path = device_trace.stop()
    assert TRACER.enabled == with_spans       # a snapshot: the tracer runs on
    TRACER.stop()
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    mine = [e for e in trace["traceEvents"] if e.get("name") == "clock.mul"]
    assert not any(e.get("name") == "before.trace" for e in trace["traceEvents"])
    if not with_spans:
        assert mine == []
        return
    (s,) = mine
    assert s["args"] == {"n": 1} and s["ph"] == "X"
    mul = next(e for e in trace["traceEvents"] if e.get("name") == "aten::mul")
    assert s["ts"] - 1000 <= mul["ts"] and mul["ts"] + mul["dur"] <= s["ts"] + s["dur"] + 1000
    rows = [e for e in trace["traceEvents"] if e.get("ph") == "M"
            and e.get("name") == "thread_name" and e.get("tid") == s["tid"]]
    assert rows and rows[0]["args"]["name"] == "siddhi_tpu_torch spans"


# ----------------------------------------------------------------- card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: host syncs and CUDA events exist only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sync_spans_are_the_blocking_calls_site_by_site(name):
    """Over a few sends of each cell's app at its real window and batch,
    every call that blocks the host on the card lies in one ``sync.*``
    span, and each such span holds one: the calls the sync debug mode
    warns of (copies to pageable memory, stream syncs), and the event
    waits, which it does not see (a patched ``Event.synchronize``)."""
    dev = _card()
    cfg = CONFIGS[name]
    rows = 65536
    m, rt, q, sink = build(cfg, device=dev, window=None)
    calls = []                       # (perf_counter_ns, kind)
    sync = torch.cuda.Event.synchronize

    def event_sync(self):
        calls.append((time.perf_counter_ns(), "event wait"))
        return sync(self)

    def warned(*_a, **_k):
        calls.append((time.perf_counter_ns(), "sync warning"))

    try:
        for g in range(4):           # captures, key tables and every key seen
            send(rt, g, rows=rows, keys=int(cfg["keys"]["count"]))
        torch.cuda.synchronize(dev)
        n = 4
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(warnings, "showwarning", warned)
                    mp.setattr(torch.cuda.Event, "synchronize", event_sync)
                    TRACER.start()
                    try:
                        for g in range(4, 4 + n):
                            send(rt, g, rows=rows, keys=int(cfg["keys"]["count"]))
                    finally:
                        trace = TRACER.stop()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        epoch = TRACER._epoch_ns
    finally:
        m.shutdown()
    syncs = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("sync.")]
    held = Counter()
    sites = Counter()
    for t, kind in calls:
        inside = [e for e in syncs
                  if epoch + e["ts"] * 1000 <= t <= epoch + (e["ts"] + e["dur"]) * 1000 + 1000]
        assert len(inside) == 1, f"a blocking call ({kind}) in {len(inside)} sync spans"
        held[id(inside[0])] += 1
        sites[(inside[0]["name"], kind)] += 1
    assert all(held[id(e)] == 1 for e in syncs), Counter(
        e["name"] for e in syncs if held[id(e)] != 1)
    print(f"{name}: over {n} sends, {dict(sites)}")
    assert sites[("sync.meta", "event wait")] == n
    assert sites[("sync.columns", "sync warning")] == n
    assert sink.rows > 0


@pytest.mark.cuda
def test_step_card_time_only_while_tracing():
    dev = _card()
    made = []
    event = torch.cuda.Event

    class Spy(event):
        def __new__(cls, *a, **k):
            made.append(k.get("enable_timing", False))
            return event.__new__(cls, *a, **k)

    m, rt, q, sink = build(DISTINCT, device=dev, window=None)
    try:
        send(rt, 0, rows=65536, keys=10000)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "Event", Spy)
            for g in range(1, 3):
                send(rt, g, rows=65536, keys=10000)
            assert made and not any(made)
            assert "step.card_ms.bench" not in rt.app_context.telemetry.snapshot().get(
                "histograms", {})
            traced(rt, 3, 3, rows=65536, keys=10000)
        h = rt.app_context.telemetry.snapshot()["histograms"]["step.card_ms.bench"]
        assert h["count"] == 3 and h["min"] > 0
        print(f"step.card_ms: {h['sum'] / h['count']:.3f} ms a step")
    finally:
        m.shutdown()


@pytest.mark.cuda
def test_epoch_places_the_benchmark_marker_kernel_inside_its_span():
    """``portbench/trace.py`` sets the profiler's clock on the tracer's by a
    marker: one fill launched inside a span, taken to start as the span
    ends. On the tracer's ``epoch_unix_ns`` the fill starts inside its span,
    after its launch: the first launch under the profiler returns
    milliseconds after its kernel has started, so the two offsets differ
    by about the span's length."""
    import sys

    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType

    from portbench.trace import MARK, Tracing

    dev = _card()
    tracing = Tracing(dev)
    tracing.start()
    torch.ones(1 << 20, device=dev).sum()
    tracing.stop()
    trace = TRACER.to_chrome_trace()
    mark = next(e for e in trace["traceEvents"] if e.get("name") == MARK)
    first = min(e.start_ns() for e in tracing.prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA)
    epoch = trace["otherData"]["epoch_unix_ns"]
    start_us = (first - epoch) / 1000.0           # the fill, on the tracer's clock
    marker_us = mark["ts"] + mark["dur"] - first / 1000.0
    print(f"the marker's span {mark['dur']:.3f} us, its fill starts {start_us - mark['ts']:.3f} us "
          f"into it; offset by the marker {marker_us:.3f} us, by the epoch "
          f"{-epoch / 1000.0:.3f} us, differ by {marker_us + epoch / 1000.0:.3f} us")
    assert mark["ts"] <= start_us <= mark["ts"] + mark["dur"]
