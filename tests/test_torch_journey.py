"""Batch journeys and the critical-path report (``observability/journey.py``)
on the port, held against the JAX package on the CPU.

The eleven scenarios of ``tests/test_journey.py`` that need the journeys
(its two cost-registry scenarios run in ``test_torch_costmodel.py``):
each scenario body runs once through the reference and once through the
port (``torch_helpers.api``), keeps the reference's own checks on the
port, and compares what the reference exposes: the set of stages the
report holds in every scenario; the bottleneck stage it names wherever
one was planted (a pack delay, a delayed @Async worker; unplanted, the
slowest stage differs by nature: XLA:CPU runs the reference's step as
device work, the port's CPU tensors run theirs inside the dispatch); the
per-stage batch counts wherever the feed is synchronous (an @Async
worker coalesces by timing). Planted delays are 20-30 ms, as the
reference's.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

from torch_helpers import api, no_tensor_reads, release_jax_programs  # noqa: F401 — autouse fixture

PKGS = ("jax", "torch")

APP = """
define stream S (sym string, v long);
@info(name='pq')
from S#window.length(8)
  select sym, sum(v) as total group by sym
  insert into Out;
"""

ASYNC_APP = """
@Async(buffer.size='1024')
define stream S (sym string, v long);
@info(name='pq')
from S#window.length(8)
  select sym, sum(v) as total group by sym
  insert into Out;
"""

CHAIN_APP = """
@Async(buffer.size='256')
define stream S (sym string, v long);
define stream Mid (sym string, v long);
@info(name='up')
from S select sym, v insert into Mid;
@info(name='down')
from Mid select sym, v insert into Out;
"""

ROUTED_APP = """
define stream S (k string, v double);
partition with (k of S)
begin
  @info(name='rq')
  from S#window.length(4) select k, v, sum(v) as s insert into Out;
end;
"""

JOIN_APP = """
define stream L (sym string, lv long);
define stream R (sym string, rv long);
@info(name='jq') from L#window.length(32) join R#window.length(32)
  on L.sym == R.sym
  select L.sym as sym, L.lv as lv, R.rv as rv insert into JOut;
"""


@pytest.fixture(autouse=True)
def _journeys_off():
    yield
    for pkg in PKGS:
        a = api(pkg)
        a.journey.disable(force=True)
        a.journey.clear_delays()
        a.costmodel.disable(force=True)


def _collector(a):
    class Collector(a.StreamCallback):
        def __init__(self):
            super().__init__()
            self.rows = []

        def receive(self, events):
            self.rows.extend(tuple(e.data) for e in events)

    return Collector()


def _manager(a, depth, extra=None):
    m = a.SiddhiManager()
    cfg = {"siddhi_tpu.pipeline_depth": str(depth)}
    cfg.update(extra or {})
    m.set_config_manager(a.InMemoryConfigManager(cfg))
    return m


def _warm(h, n=3):
    for i in range(n):
        h.send(["A", i])


def _query_report(a, m, rt, query):
    q = a.journey.critical_path_report(m)["apps"][rt.name]["queries"][query]
    assert q["bottleneck"] is not None, q
    return q


def _shape(q, counts=True, verdict=True):
    """What the comparison holds equal: the verdict (where a bottleneck
    was planted), the stages and (for a synchronous feed) each stage's
    batch count."""
    out = {"stages": sorted(q["stages"])}
    if verdict:
        out["stage"] = q["bottleneck"]["stage"]
        out["kind"] = q["bottleneck"]["kind"]
    if counts:
        out["batches"] = {s: r["batches"] for s, r in q["stages"].items()}
    return out


def _both(scenario, *args):
    """The scenario through the reference, then the port."""
    return {pkg: scenario(api(pkg), *args) for pkg in PKGS}


# -------------------------------------------------- planted bottlenecks


def _pack_bottleneck(a, depth):
    m = _manager(a, depth)
    rt = m.create_siddhi_app_runtime(APP)
    rt.add_callback("Out", _collector(a))
    h = rt.get_input_handler("S")
    _warm(h)
    a.journey.enable()
    rt.app_context.telemetry.reset()
    inj = a.FaultInjector()
    inj.delay_stage("pack", 0.02)
    try:
        for i in range(8):
            h.send(["A", i])
    finally:
        inj.clear()
    q = _query_report(a, m, rt, "pq")
    m.shutdown()
    assert q["bottleneck"]["stage"] == "pack", q["bottleneck"]
    assert q["stages"]["pack"]["mean_service_ms"] >= 15.0
    return _shape(q)


@pytest.mark.parametrize("depth", [1, 4])
def test_pack_bottleneck_named(depth):
    got = _both(_pack_bottleneck, depth)
    assert got["torch"] == got["jax"], got


def _async_queue_bottleneck(a, depth):
    m = _manager(a, depth)
    rt = m.create_siddhi_app_runtime(ASYNC_APP)
    rt.add_callback("Out", _collector(a))
    h = rt.get_input_handler("S")
    _warm(h)
    h.send([a.Event(timestamp=-1, data=["A", i]) for i in range(12)])
    time.sleep(0.3)
    a.journey.enable()
    rt.app_context.telemetry.reset()
    j = rt.junctions["S"]
    inj = a.FaultInjector()
    inj.delay_worker(j, 0.03, persistent=True)
    try:
        for i in range(12):
            h.send(["B", i])
            time.sleep(0.01)
        deadline = time.time() + 20
        while True:
            snap = rt.app_context.telemetry.snapshot().get("histograms", {})
            got = snap.get("stage.pq.queue.queue_ms", {}).get("count", 0)
            if got >= 1 and j._queue.qsize() == 0:
                break
            assert time.time() < deadline, f"queue never drained ({got})"
            time.sleep(0.05)
    finally:
        inj.clear()
    q = _query_report(a, m, rt, "pq")
    m.shutdown()
    assert q["bottleneck"]["stage"] == "queue", q["bottleneck"]
    assert q["bottleneck"]["kind"] == "queueing"
    assert q["stages"]["queue"]["mean_queue_ms"] > 2 * max(
        q["stages"][s]["mean_service_ms"] for s in ("pack", "dispatch", "device"))
    return _shape(q, counts=False)


@pytest.mark.parametrize("depth", [1, 4])
def test_async_queue_bottleneck_named(depth):
    got = _both(_async_queue_bottleneck, depth)
    assert got["torch"] == got["jax"], got


def _overlap(a):
    m = _manager(a, 4)
    rt = m.create_siddhi_app_runtime(APP)
    rt.add_callback("Out", _collector(a))
    h = rt.get_input_handler("S")
    _warm(h)
    a.journey.enable()
    rt.app_context.telemetry.reset()
    inj = a.FaultInjector()
    inj.delay_stage("pack", 0.02)
    try:
        for i in range(10):
            h.send(["A", i])
    finally:
        inj.clear()
    q = _query_report(a, m, rt, "pq")
    m.shutdown()
    pack_busy = q["stages"]["pack"]["busy_ms"]
    dev_busy = q["stages"]["device"]["busy_ms"]
    assert q["bottleneck"]["stage"] == "pack"
    # max-not-sum: the device's service is a small share of the host
    # bottleneck's busy time, and no stage is counted twice
    assert dev_busy < 0.5 * pack_busy, (dev_busy, pack_busy)
    total_busy = sum(s["busy_ms"] for s in q["stages"].values())
    assert total_busy < 2.0 * q["wall_ms"], (total_busy, q["wall_ms"])
    return _shape(q)


def test_overlap_attributed_by_max_not_sum():
    got = _both(_overlap)
    assert got["torch"] == got["jax"], got


def _sync_cascade(a):
    m = _manager(a, 1)
    rt = m.create_siddhi_app_runtime(CHAIN_APP)
    rt.add_callback("Out", _collector(a))
    h = rt.get_input_handler("S")
    _warm(h)
    time.sleep(0.3)
    a.journey.enable()
    rt.app_context.telemetry.reset()
    for i in range(6):
        h.send(["A", i])
        time.sleep(0.01)
    deadline = time.time() + 10
    while True:
        hists = rt.app_context.telemetry.snapshot().get("histograms", {})
        if hists.get("stage.down.dispatch.service_ms", {}).get("count", 0):
            break
        assert time.time() < deadline, "downstream query never ran"
        time.sleep(0.05)
    m.shutdown()
    up = hists.get("stage.up.queue.queue_ms", {}).get("count", 0) > 0
    down = "stage.down.queue.queue_ms" in hists
    assert up and not down
    return up, down


def test_sync_cascade_does_not_inherit_queue_wait():
    got = _both(_sync_cascade)
    assert got["torch"] == got["jax"], got


def _journey_off(a):
    m = _manager(a, 2)
    rt = m.create_siddhi_app_runtime(APP)
    rt.add_callback("Out", _collector(a))
    h = rt.get_input_handler("S")
    for i in range(3):
        h.send(["A", i])
    hists = rt.app_context.telemetry.snapshot().get("histograms", {})
    stages = sorted(k for k in hists if k.startswith("stage."))
    queries = a.journey.critical_path_report(m)["apps"][rt.name]["queries"]
    m.shutdown()
    assert not stages and queries == {}
    return stages, queries


def test_journey_off_leaves_no_trace():
    got = _both(_journey_off)
    assert got["torch"] == got["jax"], got


def _profile_knobs(a):
    m = _manager(a, 2, {"siddhi_tpu.profile_journeys": "true",
                        "siddhi_tpu.profile_costs": "on"})
    rt = m.create_siddhi_app_runtime(APP)
    rt.add_callback("Out", _collector(a))
    rt.start()
    on = (a.journey.enabled(), a.costmodel.enabled())
    rt.get_input_handler("S").send(["A", 1])
    keys = any(p.key == "query.pq.step" for p in a.costmodel.registry().programs())
    hists = rt.app_context.telemetry.snapshot().get("histograms", {})
    stages = sorted({k.split(".")[2] for k in hists if k.startswith("stage.pq.")})
    m.shutdown()
    off = a.journey.enabled()
    assert on == (True, True) and keys and stages and not off
    return on, keys, stages, off


def test_profile_knobs_enable_collectors():
    got = _both(_profile_knobs)
    assert got["torch"] == got["jax"], got


# --------------------------------------------- routed and engine joins


def _routed(a, n_dev):
    feed = [[f"P{i % 16}", float(i)] for i in range(160)]
    m0 = _manager(a, 4)
    rt0 = m0.create_siddhi_app_runtime(ROUTED_APP)
    ref = _collector(a)
    rt0.add_callback("Out", ref)
    h0 = rt0.get_input_handler("S")
    for row in feed:
        h0.send(row)
    m0.shutdown()
    m = _manager(a, 4)
    rt = m.create_siddhi_app_runtime(ROUTED_APP)
    c = _collector(a)
    rt.add_callback("Out", c)
    q = rt.query_runtimes["rq"]
    a.device_route_query_step(q, a.make_mesh(n_dev), rows_per_shard=256)
    h = rt.get_input_handler("S")
    for row in feed[:32]:
        h.send(row)
    a.journey.enable()
    rt.app_context.telemetry.reset()
    for row in feed[32:]:
        h.send(row)
    qrep = _query_report(a, m, rt, "rq")
    m.shutdown()
    for stage in ("pack", "dispatch", "device", "emit"):
        assert qrep["stages"].get(stage, {}).get("batches", 0) > 0, stage
    assert c.rows == ref.rows
    assert q._instr_last["shard_rows"].shape == (n_dev,)
    return _shape(qrep, verdict=False), c.rows


@pytest.mark.parametrize("n_dev", [2, 4])
def test_routed_query_stage_attribution(n_dev):
    got = _both(_routed, n_dev)
    assert got["torch"][0] == got["jax"][0], (got["torch"][0], got["jax"][0])
    assert got["torch"][1] == got["jax"][1]


def _device_join(a, n_parts):
    m = _manager(a, 4, {"siddhi_tpu.join_partitions": str(n_parts),
                        "siddhi_tpu.join_partition_slack": "8"})
    rt = m.create_siddhi_app_runtime(JOIN_APP)
    c = _collector(a)
    rt.add_callback("JOut", c)
    q = rt.query_runtimes["jq"]
    assert q.engine is not None, q.engine_reason
    hl, hr = rt.get_input_handler("L"), rt.get_input_handler("R")
    hl.send(["S0", 0])
    hr.send(["S0", 100])
    a.journey.enable()
    rt.app_context.telemetry.reset()
    for i in range(24):
        hl.send([f"S{i % 3}", i])
        hr.send([f"S{i % 3}", 100 + i])
    qrep = _query_report(a, m, rt, "jq")
    counters = rt.app_context.telemetry.snapshot()["counters"]
    m.shutdown()
    for stage in ("pack", "dispatch", "device", "emit"):
        assert qrep["stages"].get(stage, {}).get("batches", 0) > 0, stage
    assert c.rows
    assert counters.get("join.seq_breaks", 0) == 0
    assert getattr(q, "seq_breaks", 0) == 0
    return _shape(qrep, verdict=False), sorted(c.rows)


@pytest.mark.parametrize("n_parts", [2, 4])
def test_device_join_stage_attribution(n_parts):
    got = _both(_device_join, n_parts)
    assert got["torch"][0] == got["jax"][0], (got["torch"][0], got["jax"][0])
    assert got["torch"][1] == got["jax"][1]


# ------------------------------------------------------------------ REST


def _post(url, body=None):
    req = urllib.request.Request(url, data=json.dumps(body or {}).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read().decode())


def _rest_profile(a, tmp):
    a.costmodel.registry().reset()
    m = _manager(a, 2)
    rt = m.create_siddhi_app_runtime(APP)
    rt.add_callback("Out", _collector(a))
    base_dir = tmp / a.pkg
    svc = a.SiddhiRestService(m, trace_base=str(base_dir)).start()
    base = f"http://127.0.0.1:{svc.port}"
    codes = []
    try:
        st, body = _post(f"{base}/profile/journeys/start")
        codes.append(st)
        assert body["journeys"] is True
        st, body = _post(f"{base}/profile/costs/start")
        codes.append(st)
        assert body["costs"] is True
        h = rt.get_input_handler("S")
        for i in range(4):
            h.send(["A", i])
        st, rep = _get(f"{base}/profile/critical_path/{rt.name}")
        codes.append(st)
        q = rep["apps"][rt.name]["queries"]["pq"]
        assert set(q["stages"]) >= {"pack", "dispatch", "device", "emit"}
        assert q["bottleneck"]["stage"] in rep["stage_glossary"]
        st, progs = _get(f"{base}/programs")
        codes.append(st)
        assert any(p["key"] == "query.pq.step" for p in progs["programs"])
        st, body = _post(f"{base}/profile/journeys/stop")
        codes.append(st)
        assert body["journeys"] is False
        codes.append(_post(f"{base}/profile/costs/stop")[0])
        codes.append(_post(f"{base}/profile/device/start", {"dir": "../escape"})[0])
        st, body = _post(f"{base}/profile/device/start", {"dir": "prof1"})
        codes.append(st)
        assert body["device_profile"].startswith(str(base_dir))
        codes.append(_post(f"{base}/profile/device/start", {"dir": "prof2"})[0])
        st, body = _post(f"{base}/profile/device/stop")
        codes.append(st)
        assert body["device_profile"] is None
        codes.append(_post(f"{base}/profile/device/stop")[0])
    finally:
        svc.stop()
        m.shutdown()
    return codes, rep["stage_glossary"], sorted(q["stages"])


def test_rest_profile_endpoints(tmp_path):
    got = _both(_rest_profile, tmp_path)
    assert got["torch"] == got["jax"], got
    assert got["torch"][0] == [200, 200, 200, 200, 200, 200, 400, 200, 409, 200, 409]


# ------------------------------------------------------ exposition, scrape


def _assert_valid_exposition(text):
    sample = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
        r'(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\\n])*",?)*\})?'
        r' (NaN|[-+0-9.e]+)$')
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        assert sample.match(line), f"malformed exposition line: {line!r}"


def _escaping(a):
    m = _manager(a, 2)
    rt = m.create_siddhi_app_runtime(APP)
    hostile = 'ev"il\\str\neam'
    tel = rt.app_context.telemetry
    tel.gauge(f"junction.{hostile}.queue_depth", lambda: 7)
    tel.count(f"junction.{hostile}.backpressure_stalls", 3)
    tel.count(f'overload.{hostile}.events', 2)
    text = a.export.prometheus_text(m)
    _assert_valid_exposition(text)
    snap = a.export.json_snapshot(m)
    m.shutdown()
    lines = sorted(ln for ln in text.splitlines() if "ev\\\"il" in ln)
    assert 'ev\\"il\\\\str\\neam' in text
    assert "\neam" not in text.replace("\\neam", "")
    assert snap["apps"][rt.name]["telemetry"]["gauges"][
        f"junction.{hostile}.queue_depth"] == 7
    return lines


def test_prometheus_escaping_hostile_label_values():
    got = _both(_escaping)
    # the app label differs (a generated name); the families do not
    strip = [[re.sub(r'app="[^"]*"', "", ln) for ln in got[p]] for p in PKGS]
    assert strip[1] == strip[0], strip


def _scrape_hygiene(a):
    m = _manager(a, 2)
    rt = m.create_siddhi_app_runtime(ASYNC_APP)
    rt.add_callback("Out", _collector(a))
    h = rt.get_input_handler("S")
    h.send(["A", 1])
    inj = a.FaultInjector()
    j = rt.junctions["S"]
    inj.wedge_worker(j)
    h.send(["A", 2])
    assert inj.wait_wedged(10.0), "worker never wedged"
    result = {}

    def scrape():
        if a.pkg == "jax":
            import jax

            guard = jax.transfer_guard("disallow")
        else:
            guard = no_tensor_reads()
        with guard:
            result["text"] = a.export.prometheus_text(m)

    with rt._barrier:
        t = threading.Thread(target=scrape, daemon=True)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive(), "scrape blocked on the app barrier"
    assert "siddhi_junction_queue_depth" in result["text"]
    for line in result["text"].splitlines():
        if line.startswith(("siddhi_device_instrument", "siddhi_join_partition_rows")):
            assert not line.endswith("NaN"), line
    inj.release()
    inj.clear()
    text2 = a.export.prometheus_text(m)
    m.shutdown()
    assert "siddhi_scrape_ms" in text2 and "siddhi_scrape_ms_count" in text2
    return sorted({ln.split("{")[0].split(" ")[0] for ln in result["text"].splitlines()
                   if ln.startswith(("siddhi_junction", "siddhi_device", "siddhi_pipeline"))})


def test_scrape_self_histogram_and_no_barrier():
    got = _both(_scrape_hygiene)
    assert got["torch"] == got["jax"], got
