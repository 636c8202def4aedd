"""The port's REST service (``service/rest.py``), metrics export
(``observability/export.py``) and doc generator (``utils/docgen.py``), on
the CPU. Every service binds port 0 and every thread joins with a timeout.

The four scenarios of ``tests/test_service.py`` drive the port through
the module's own requests and checks (``torch_helpers.port_corpus``). The
span tracer's, the device trace's, the critical-path profiler's, the
autopilot's and the cluster fabric's routes answer as the reference's
service answers the same request; a wire frame posted to ``/ingest``
lands as ``send_columns`` would land it; ``/metrics`` renders the
families the port has sources for and none of the unported ones.
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


# the routes that answered 501 until the autopilot and the cluster fabric
# were ported (ROADMAP A.10 c and d): now each answers as the reference's
# service answers it with the fixture's app not under autopilot control
# and no fabric attached (the status and a word its answer names)
UNPORTED = [
    ("GET", "/autopilot", 200, "actuators"),
    ("GET", "/autopilot/R", 404, "not under autopilot control"),
    ("GET", "/cluster", 404, "no cluster fabric"),
]

# the routes ROADMAP A.10 (a) ported: each request answered as the
# reference's service answers it (200, or 409 for a stop with nothing
# running), then the switch it turned on is turned off again
PORTED = [
    ("POST", "/trace/start", {}, ("POST", "/trace/stop", {})),
    ("POST", "/trace/stop", {}, None),
    ("POST", "/apps/R/trace", {"action": "start", "dir": "t"},
     ("POST", "/apps/R/trace", {"action": "stop"})),
    ("GET", "/profile/critical_path", None, None),
    ("POST", "/profile/journeys/start", {}, ("POST", "/profile/journeys/stop", {})),
    ("POST", "/profile/device/start", {}, ("POST", "/profile/device/stop", {})),
]


@pytest.mark.parametrize("method,path,status,word", UNPORTED,
                         ids=[f"{m} {p}" for m, p, _s, _w in UNPORTED])
def test_unported_route_answers_501_naming_its_item(service, method, path, status, word):
    """Formerly the 501 of an unported route; each route now answers as the
    reference's does: ``/autopilot`` the controller's report (actuators,
    log capacity, registered apps), ``/autopilot/R`` 404 for a deployed app
    the autopilot does not control, ``/cluster`` 404 with no fabric."""
    _m, svc = service
    code, payload = _call(svc.port, method, path)
    assert code == status, (code, payload)
    body = json.loads(payload)
    if status == 200:
        assert word in body and body["decision_log_capacity"] == 256
        assert "R" not in body["apps"]
    else:
        assert word in body["error"], body


def _answer(pkg, tmp, method, path, body, undo):
    """(status, sorted top-level keys of the JSON answer) of one request to
    a fresh service of ``pkg`` over the fixture's app; ``undo`` runs after."""
    if pkg == "jax":
        from siddhi_tpu import SiddhiManager
        from siddhi_tpu.service import SiddhiRestService
        m = SiddhiManager()
    else:
        from siddhi_tpu_torch import SiddhiManager
        from siddhi_tpu_torch.service import SiddhiRestService
        m = SiddhiManager(device="cpu")
    svc = SiddhiRestService(m, trace_base=str(tmp / pkg)).start()
    try:
        app = ("@app:name('R') @app:playback define stream S (sym string, v long); "
               "from S select sym, v insert into O;")
        assert _call(svc.port, "POST", "/apps", raw=app.encode(), ctype="text/plain")[0] == 201
        code, payload = _call(svc.port, method, path, body)
        keys = sorted(json.loads(payload))
        if undo is not None:
            assert _call(svc.port, *undo)[0] == 200, undo
        return code, keys
    finally:
        svc.stop()
        m.shutdown()


@pytest.mark.parametrize("method,path,body,undo", PORTED,
                         ids=[f"{m} {p}" for m, p, _b, _u in PORTED])
def test_ported_route_answers_as_the_reference(tmp_path, method, path, body, undo):
    """The span tracer's, the device trace's and the critical-path
    profiler's routes (ROADMAP A.10 a): the same request to the
    reference's service and to the port's gets the same status and the
    same answer keys."""
    want = _answer("jax", tmp_path, method, path, body, undo)
    got = _answer("torch", tmp_path, method, path, body, undo)
    assert got == want, (got, want)
    assert want[0] in (200, 409), want


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
    """Formerly a refusal naming ROADMAP A.10: the ``cluster=`` argument
    now attaches a fabric, whose ``status()`` ``GET /cluster`` serves and
    the ``/metrics`` JSON carries under ``"cluster"``, and whose apps
    ``POST /query`` scatter-gathers (a stand-in fabric here: the real one
    runs in ``tests/test_torch_cluster.py``)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.service import SiddhiRestService

    class Fabric:
        apps = {"F": object()}

        def status(self):
            return {"workers": 2, "live": 2, "apps": {"F": {"mode": "split"}}}

        def query(self, app, text):
            return [(0, ["k", 1]), (0, ["m", 2])]

    m = SiddhiManager(device="cpu")
    svc = SiddhiRestService(m, cluster=Fabric()).start()
    try:
        code, payload = _call(svc.port, "GET", "/cluster")
        assert code == 200 and json.loads(payload) == Fabric().status()
        code, payload = _call(svc.port, "GET", "/metrics?format=json")
        assert code == 200 and json.loads(payload)["cluster"] == Fabric().status()
        code, payload = _call(svc.port, "POST", "/query",
                              {"app": "F", "query": "from T select k, n"})
        assert code == 200 and json.loads(payload) == {"rows": [["k", 1], ["m", 2]]}
    finally:
        svc.stop()
        m.shutdown()


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
    # the supervisor's and the overload layer's counters are declared at 0
    # (ported since ROADMAP A.10 b), the supervisor's peer counters too
    # (since A.9)
    for name in ("resilience.worker_restarts", "resilience.shed_events",
                 "resilience.peer_failures", "resilience.peer_recoveries"):
        assert f'siddhi_counter_total{{app="R",name="{name}"}} 0' in text, name
    # the journeys' families are not printed (journeys are off), nor the
    # device instruments' (this app's step declares no slot) nor the
    # autopilot's (the app is not registered)
    for family in ("siddhi_stage_", "siddhi_device_instrument",
                   "siddhi_autopilot"):
        assert family not in text, family
    code, payload = _call(svc.port, "GET", "/metrics/R?format=json")
    snap = json.loads(payload)
    assert code == 200 and set(snap) == {"apps", "process"}
    assert snap["apps"]["R"]["telemetry"]["gauges"]["wal.batches"] == 1
    assert _call(svc.port, "GET", "/metrics/Nope")[0] == 404
    # the autopilot's and the cluster fabric's families render once their
    # source exists (ported in ROADMAP A.10 c and d): a registered app, a
    # tick, and a router (no worker processes)
    from siddhi_tpu_torch.autopilot import AutopilotController
    from siddhi_tpu_torch.cluster import ClusterRuntime

    rt.enable_autopilot(mode="dry_run", interval_s=3600)
    AutopilotController.instance().tick("R", now=1000.0)
    cluster = ClusterRuntime(n_workers=1, spawn=False, device="cpu")
    try:
        text = _call(svc.port, "GET", "/metrics")[1].decode()
    finally:
        cluster.shutdown()
    assert 'siddhi_autopilot_mode{app="R"} 1' in text
    assert 'siddhi_autopilot_ticks_total{app="R"} 1' in text
    assert "siddhi_cluster_workers_live 0" in text
    assert 'siddhi_cluster_worker_acked_seq{worker="0"} 0' in text


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
