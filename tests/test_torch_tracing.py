"""Span tracing (``observability/tracing.py``), the @Async junction gauges
and counters, and the fault injector's worker hooks on the port, held
against the JAX package on the CPU.

The scenarios of ``tests/test_observability.py`` over spans and the
@Async queue: span nesting, thread safety, the ring bound with its
disabled no-op, the REST trace start/stop Chrome dump, the queue-depth
gauge under an @Async soak against a wedged worker and the backpressure
stall counter (both planted through ``FaultInjector``). Each runs through
both packages (``torch_helpers.api``) with the reference's own checks,
and what the reference exposes is compared: span names and nesting, not
times. Last, an app that plans, compiles, runs a fused group, publishes
to a sink and persists records the same spans in both packages.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from collections import Counter, defaultdict

import pytest

from torch_helpers import api, release_jax_programs  # noqa: F401 — autouse fixture

PKGS = ("jax", "torch")


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    for pkg in PKGS:
        api(pkg).tracing.TRACER.enabled = False


def _both(scenario, *args):
    got = {pkg: scenario(api(pkg), *args) for pkg in PKGS}
    assert got["torch"] == got["jax"], got
    return got["torch"]


def _collector(a):
    class Collector(a.StreamCallback):
        def __init__(self):
            super().__init__()
            self.events = []

        def receive(self, events):
            self.events.extend(events)

    return Collector()


def _complete_events(trace):
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    for e in evs:
        for key in ("name", "pid", "tid", "ts", "dur"):
            assert key in e, f"chrome event missing '{key}': {e}"
        assert e["dur"] > 0
    return evs


def _nesting(events):
    """Per tid, every pair of spans is disjoint or contained (the Trace
    Event Format's contract for complete events); returns the multiset of
    (parent name, name) pairs, the structure the packages share."""
    by_tid = defaultdict(list)
    for e in events:
        by_tid[e["tid"]].append(e)
    eps = 0.01
    pairs = Counter()
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - eps:
                stack.pop()
            if stack:
                assert e["ts"] + e["dur"] <= stack[-1]["ts"] + stack[-1]["dur"] + eps, \
                    f"span {e} escapes its parent {stack[-1]}"
            pairs[(stack[-1]["name"] if stack else None, e["name"])] += 1
            stack.append(e)
    return pairs


# ------------------------------------------------------------------ spans


def _nested(a):
    t = a.tracing.Tracer(capacity=1024)
    t.start()
    with t.span("outer", kind="test"):
        with t.span("mid"):
            with t.span("inner"):
                time.sleep(0.001)
        with t.span("mid2"):
            time.sleep(0.001)
    evs = _complete_events(t.stop())
    pairs = _nesting(evs)
    outer = next(e for e in evs if e["name"] == "outer")
    assert outer["args"] == {"kind": "test"}
    return sorted(pairs.items(), key=str)


def test_span_nesting_structure():
    pairs = dict(_both(_nested))
    assert pairs == {(None, "outer"): 1, ("outer", "mid"): 1, ("mid", "inner"): 1,
                     ("outer", "mid2"): 1}


def _threads(a):
    t = a.tracing.Tracer(capacity=100_000)
    t.start()
    n_threads, n_iters = 8, 200
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait()
        for i in range(n_iters):
            with t.span("outer", i=i):
                with t.span("mid"):
                    with t.span("inner"):
                        pass

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    evs = _complete_events(t.stop())
    assert len(evs) == n_threads * n_iters * 3
    assert len({e["tid"] for e in evs}) == n_threads
    return sorted(_nesting(evs).items(), key=str)


def test_span_thread_safety():
    _both(_threads)


def _ring(a):
    t = a.tracing.Tracer(capacity=16)
    t.start()
    for i in range(100):
        with t.span("s", i=i):
            pass
    assert len(t) == 16
    trace = t.stop()
    kept = sorted(e["args"]["i"] for e in trace["traceEvents"] if e.get("ph") == "X")
    assert not a.tracing.TRACER.enabled
    with a.tracing.span("ignored", x=1):
        pass
    assert len(a.tracing.TRACER) == 0
    return trace["otherData"]["dropped_spans"], kept


def test_span_ring_buffer_bound_and_disabled_noop():
    dropped, kept = _both(_ring)
    assert dropped == 84 and kept == list(range(84, 100))


# ------------------------------------------------------------------- REST


def _req(port, method, path, body=None, as_json=True):
    data, headers = None, {}
    if body is not None:
        data = (json.dumps(body) if as_json else body).encode()
        headers["Content-Type"] = "application/json" if as_json else "text/plain"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers, method=method)
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read().decode())


def _rest_trace(a, tmp):
    m = a.SiddhiManager()
    base = tmp / a.pkg
    svc = a.SiddhiRestService(m, trace_base=str(base)).start()
    p = svc.port
    codes = []
    try:
        _req(p, "POST", "/apps", "@app:name('TrSpanApp') define stream S (v int); "
             "from S[v > 0] select v insert into O;", as_json=False)
        assert _req(p, "POST", "/trace/start", {})["tracing"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(p, "POST", "/trace/start", {})
        codes.append(ei.value.code)
        for i in range(3):
            _req(p, "POST", "/apps/TrSpanApp/events", {"stream": "S", "data": [[i + 1]]})
        got = _req(p, "POST", "/trace/stop", {"file": "soak/spans.json"})
        assert got["tracing"] is False and got["events"] > 0
        assert got["file"].startswith(str(base))
        with open(got["file"], encoding="utf-8") as f:
            trace = json.load(f)
        evs = _complete_events(trace)
        names = {e["name"] for e in evs}
        assert "junction.dispatch" in names and "query.step" in names
        pairs = _nesting(evs)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(p, "POST", "/trace/stop", {})
        codes.append(ei.value.code)
        _req(p, "POST", "/trace/start", {})
        for name in ("../../etc/passwd", "."):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _req(p, "POST", "/trace/stop", {"file": name})
            codes.append(ei.value.code)
        assert a.tracing.TRACER.enabled      # a refused stop left it running
        _req(p, "POST", "/trace/stop", {})
    finally:
        a.tracing.TRACER.enabled = False
        svc.stop()
        m.shutdown()
    return codes, sorted(names), sorted(pairs.items(), key=str)


def test_rest_trace_start_stop_dumps_chrome_json(tmp_path):
    codes, names, _pairs = _both(_rest_trace, tmp_path)
    assert codes == [409, 409, 400, 400]
    assert {"junction.dispatch", "query.step", "jit"} <= set(names)


# --------------------------------------------------- @Async gauges, counters


def _soak(a):
    m = a.SiddhiManager()
    rt = m.create_siddhi_app_runtime("""
        @app:name('SoakApp')
        @Async(buffer.size='256', batch.size='16')
        define stream S (sym string, v long);
        from S select sym, v insert into Out;
    """)
    c = _collector(a)
    rt.add_callback("Out", c)
    rt.start()
    tel = rt.app_context.telemetry
    inj = a.FaultInjector()
    j = rt.junctions["S"]
    h = rt.get_input_handler("S")
    try:
        inj.wedge_worker(j)
        h.send(["a", 0])
        assert inj.wait_wedged(10.0)
        for i in range(50):
            h.send(["a", i])
        depth = tel.read_gauges()["junction.S.queue_depth"]
        assert depth >= 50
    finally:
        inj.release()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        g = tel.read_gauges()
        if (g["junction.S.queue_depth"] == 0 and g["junction.S.inflight_batches"] == 0
                and len(c.events) == 51):
            break
        time.sleep(0.02)
    g = tel.read_gauges()
    m.shutdown()
    return (depth, g["junction.S.queue_depth"], g["junction.S.inflight_batches"],
            len(c.events))


def test_queue_depth_gauge_under_async_soak():
    assert _both(_soak) == (50, 0, 0, 51)


def _stalls(a):
    m = a.SiddhiManager()
    rt = m.create_siddhi_app_runtime("""
        @app:name('StallApp')
        @Async(buffer.size='4', batch.size='4')
        define stream S (v long);
        from S select v insert into Out;
    """)
    c = _collector(a)
    rt.add_callback("Out", c)
    rt.start()
    inj = a.FaultInjector()
    j = rt.junctions["S"]
    h = rt.get_input_handler("S")
    inj.wedge_worker(j)
    h.send([0])
    assert inj.wait_wedged(10.0)

    def pump():
        for i in range(8):
            h.send([i])

    t = threading.Thread(target=pump)
    t.start()
    deadline = time.monotonic() + 10.0
    tel = rt.app_context.telemetry
    while time.monotonic() < deadline:
        if tel.counters.get("junction.S.backpressure_stalls", 0) > 0:
            break
        time.sleep(0.02)
    stalls = tel.counters.get("junction.S.backpressure_stalls", 0)
    inj.release()
    t.join(timeout=10)
    m.shutdown()
    assert stalls > 0
    return stalls > 0, len(c.events)


def test_backpressure_stall_counter():
    assert _both(_stalls) == (True, 9)


# ------------------------------------------------------- an app's spans


def _app_spans(a):
    """Compile, plan and assemble an app with a fused fan-out group, an
    inMemory sink and persistence, send three batches, persist: the spans
    and their nesting."""
    if a.pkg == "jax":
        from siddhi_tpu.core.util.persistence import InMemoryPersistenceStore
    else:
        from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore
    t = a.tracing.TRACER
    t.start()
    try:
        m = a.SiddhiManager()
        m.set_persistence_store(InMemoryPersistenceStore())
        rt = m.create_siddhi_app_runtime("""
            @app:name('SpanApp')
            define stream S (sym string, v long);
            @sink(type='inMemory', topic='span_app')
            define stream O1 (sym string, t long);
            @info(name='q1') from S#window.length(4) select sym, sum(v) as t insert into O1;
            @info(name='q2') from S[v > 1] select sym, v as t insert into O2;
        """)
        h = rt.get_input_handler("S")
        for i in range(3):
            h.send(["a", i])
        rt.persist()
        m.shutdown()
        trace = t.stop()
    finally:
        t.enabled = False
    pairs = _nesting(_complete_events(trace))
    return sorted(pairs.items(), key=str)


def test_app_records_the_reference_spans():
    pairs = dict(_both(_app_spans))
    names = {n for _p, n in pairs}
    assert {"compile", "assemble", "plan", "jit", "junction.dispatch", "fanout.step",
            "sink.publish", "persist"} <= names, names
