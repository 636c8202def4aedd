"""The port's REST service (``service/rest.py``), metrics export
(``observability/export.py``) and doc generator (``utils/docgen.py``), on
the CPU. Every service binds port 0 and every thread joins with a timeout.

The four scenarios of ``tests/test_service.py`` drive the port through
the module's own requests and checks (``torch_helpers.port_corpus``). The
reference's routes over modules the port lacks answer 501 naming their
ROADMAP item; a wire frame posted to ``/ingest`` lands as ``send_columns``
would land it; ``/metrics`` renders the families the port has sources
for and none of the unported ones.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_helpers import port_corpus, release_jax_programs  # noqa: F401 — autouse fixture

MOD, SCENARIOS = port_corpus("test_service")


def test_every_scenario_is_collected():
    assert len(SCENARIOS) == 4, SCENARIOS


@pytest.mark.parametrize("name", SCENARIOS)
def test_service_corpus_on_port(name):
    getattr(MOD, name)()


def _call(port, method, path, body=None, raw=None, ctype="application/json"):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"Content-Type": ctype} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture()
def service():
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.service import SiddhiRestService

    m = SiddhiManager(device="cpu")
    svc = SiddhiRestService(m).start()
    app = ("@app:name('R') @app:playback define stream S (sym string, v long); "
           "from S select sym, v insert into O;")
    assert _call(svc.port, "POST", "/apps", raw=app.encode(), ctype="text/plain")[0] == 201
    yield m, svc
    svc.stop()
    m.shutdown()
    assert not svc._thread.is_alive()


UNPORTED = [
    ("POST", "/trace/start", {}, "A.10"),
    ("POST", "/trace/stop", {}, "A.10"),
    ("POST", "/apps/R/trace", {"action": "start", "dir": "t"}, "A.10"),
    ("GET", "/profile/critical_path", None, "A.10"),
    ("POST", "/profile/journeys/start", {}, "A.10"),
    ("POST", "/profile/device/start", {}, "A.10"),
    ("GET", "/autopilot", None, "A.10"),
    ("GET", "/autopilot/R", None, "A.10"),
    ("GET", "/cluster", None, "A.10"),
]


@pytest.mark.parametrize("method,path,body,item", UNPORTED,
                         ids=[f"{m} {p}" for m, p, _b, _i in UNPORTED])
def test_unported_route_answers_501_naming_its_item(service, method, path, body, item):
    _m, svc = service
    code, payload = _call(svc.port, method, path, body)
    assert code == 501, (code, payload)
    err = json.loads(payload)["error"]
    assert f"ROADMAP {item}" in err, err


PROGRAM_ROUTES = [("GET", "/programs"), ("POST", "/profile/costs/start"),
                  ("POST", "/profile/costs/stop")]


@pytest.mark.parametrize("method,path", PROGRAM_ROUTES,
                         ids=[f"{m} {p}" for m, p in PROGRAM_ROUTES])
def test_program_routes_answer_as_the_reference(service, method, path):
    """``GET /programs`` serves the cost registry's records and clusters
    beside the program cache's entries (the app's one query step holds
    one after a send); the cost switch answers ``{"costs", "programs"}``."""
    from siddhi_tpu_torch.observability import costmodel

    _m, svc = service
    try:
        code, payload = _call(svc.port, "POST", "/apps/R/events",
                              {"stream": "S", "data": ["a", 1], "timestamp": 5})
        assert code == 200, payload
        code, payload = _call(svc.port, method, path, {} if method == "POST" else None)
        assert code == 200, payload
        body = json.loads(payload)
        if path == "/programs":
            assert {"programs", "clusters", "cache"} <= set(body)
            entries = body["cache"]["entries"]
            assert any(e["family"] == "query_step" and e["shared_by"] == ["R"]
                       for e in entries), entries
        else:
            assert body["costs"] is path.endswith("start")
            assert isinstance(body["programs"], int)
    finally:
        costmodel.disable(force=True)


def test_cluster_argument_is_refused_by_name():
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.service import SiddhiRestService

    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.10"):
        SiddhiRestService(SiddhiManager(device="cpu"), cluster=object())


def test_ingest_wire_frame_equals_send_columns(service):
    """POST /ingest/S with one wire frame (per-row timestamps) gives the
    rows ``send_columns`` gives; a malformed frame answers 400 and lands
    nothing; the wire counters and the app's statistics see the frame."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.core.stream.input.wire import WireEncoder

    m, svc = service
    rt = m.get_siddhi_app_runtime("R")
    rt.set_statistics_level("basic")
    rows = []

    class C(StreamCallback):
        def receive(self, events):
            rows.extend((e.timestamp, *e.data) for e in events)

    rt.add_callback("O", C())
    cols = {"sym": np.array(["a", "b", "a"], object), "v": np.array([1, 2, 3], np.int64)}
    ts = np.array([10, 11, 12], np.int64)
    frame = WireEncoder().encode(cols, timestamps=ts)
    code, payload = _call(svc.port, "POST", "/ingest/S", raw=frame,
                          ctype="application/octet-stream")
    assert code == 200 and json.loads(payload) == {"accepted": 3, "stream": "S", "app": "R"}
    code, _p = _call(svc.port, "POST", "/ingest/S", raw=b"\x00" * 7,
                     ctype="application/octet-stream")
    assert code == 400
    assert _call(svc.port, "POST", "/ingest/Nope", raw=frame)[0] == 404

    m2 = SiddhiManager(device="cpu")
    rt2 = m2.create_siddhi_app_runtime(rt.siddhi_app)
    want = []

    class W(StreamCallback):
        def receive(self, events):
            want.extend((e.timestamp, *e.data) for e in events)

    rt2.add_callback("O", W())
    rt2.get_input_handler("S").send_columns(cols, timestamps=ts)
    m2.shutdown()
    assert rows == want == [(10, "a", 1), (11, "b", 2), (12, "a", 3)]
    counters = rt.app_context.telemetry.snapshot()["counters"]
    assert counters["ingest.wire.frames"] == 1 and counters["ingest.wire.events"] == 3
    assert rt.statistics()["throughput"]["S"]["events"] == 3


def test_metrics_text_and_json(service):
    m, svc = service
    rt = m.get_siddhi_app_runtime("R")
    rt.enable_wal()
    rt.set_statistics_level("basic")
    rt.get_input_handler("S").send(5, ["a", 1])
    code, text = _call(svc.port, "GET", "/metrics")
    assert code == 200
    text = text.decode()
    assert 'siddhi_statistics_level{app="R"} 1' in text
    assert 'siddhi_stream_events_total{app="R",stream="S"} 1' in text
    assert 'siddhi_counter_total{app="R",name="resilience.wal_replayed_batches"} 0' in text
    assert 'siddhi_gauge{app="R",name="wal.batches"} 1' in text
    # the query's step went through the step instrument and holds a
    # program-cache entry (ported families, printed since ROADMAP A.8 b)
    assert 'siddhi_jit_compiles_total{app="R",key="query.' in text
    assert "siddhi_program_cache_misses_total" in text
    assert "siddhi_program_cache_size" in text
    # the families of unported sources are not printed, not even as zeros
    for family in ("siddhi_stage_", "siddhi_device_instrument",
                   "siddhi_autopilot", "siddhi_cluster",
                   "resilience.worker_restarts", "resilience.shed_events"):
        assert family not in text, family
    code, payload = _call(svc.port, "GET", "/metrics/R?format=json")
    snap = json.loads(payload)
    assert code == 200 and set(snap) == {"apps", "process"}
    assert snap["apps"]["R"]["telemetry"]["gauges"]["wal.batches"] == 1
    assert _call(svc.port, "GET", "/metrics/Nope")[0] == 404


def test_query_storm_sheds_503_past_the_cap():
    """A gated query pool: requests past the endpoint's cap answer 503
    with ``Retry-After`` and ``"shed": true``, never 500; the app's
    ``resilience.query_sheds`` counts them."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.service import SiddhiRestService

    m = SiddhiManager(device="cpu")
    svc = SiddhiRestService(m, query_workers=1, query_queue_cap=2).start()
    try:
        _call(svc.port, "POST", "/apps", raw=(
            "@app:name('Q') @app:statistics('true') define stream S (v long); "
            "define table T (v long); from S insert into T;").encode(), ctype="text/plain")
        rt = m.get_siddhi_app_runtime("Q")
        gate = threading.Event()
        orig = rt.query
        rt.query = lambda q: (gate.wait(10), orig(q))[1]
        codes, heads = [], []

        def client():
            req = urllib.request.Request(
                f"http://127.0.0.1:{svc.port}/query", method="POST",
                data=json.dumps({"app": "Q", "query": "from T select v"}).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                heads.append((e.headers.get("Retry-After"), json.loads(e.read())))

        threads = [threading.Thread(target=client) for _ in range(6)]
        for t in threads:
            t.start()
        for _ in range(1000):
            if len(heads) >= 4:
                break
            threading.Event().wait(0.01)
        gate.set()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert sorted(codes) == [200, 200, 503, 503, 503, 503]
        assert all(ra == "1" and body["shed"] is True for ra, body in heads)
        assert rt.statistics()["counters"]["resilience.query_sheds"] == 4
    finally:
        svc.stop()
        m.shutdown()
