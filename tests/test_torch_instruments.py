"""Device instruments (``observability/instruments.py``) on the port, held
against the JAX package on the CPU.

The eleven scenarios of ``tests/test_device_instruments.py``, each run
through the reference and the port (``torch_helpers.api``): every data
lane a runtime decodes is recorded batch by batch
(``torch_helpers.lane_recorder``) and the two packages' lanes are equal
exactly (they are counts); the reference's checks hold on the port. The
reference's transfer guard becomes ``torch_helpers.no_tensor_reads`` (a
host read of a tensor's values raises), and its jitted steps the port's
steps called on CPU tensors. Beyond them: an app with instruments on and
one with them off never share a program-cache entry, and on the card a
captured step's lanes equal the eager step's (``-m cuda``).
"""

import numpy as np
import pytest
import torch

from torch_helpers import (api, lane_recorder, no_tensor_reads,  # noqa: F401
                           release_jax_programs)

PKGS = ("jax", "torch")

JOIN_APP = """
define stream L (sym string, lv long);
define stream R (sym string, rv long);
@info(name='jq') from L#window.length(64) join R#window.length(64)
  on L.sym == R.sym
  select L.sym as sym, L.lv as lv, R.rv as rv insert into JOut;
"""

KEYED_APP = """
define stream S (k string, v double);
partition with (k of S)
begin
  @info(name='kq')
  from S#window.length(8) select k, v, sum(v) as s insert into Out;
end;
"""

ROUTED_APP = KEYED_APP.replace("kq", "rq").replace("length(8)", "length(4)")

NFA_APP = """
define stream A (sym string, p double);
@info(name='nq') from every e1=A[p > 10] -> e2=A[p > e1.p]
  select e1.sym as s1, e2.sym as s2 insert into Out;
"""

FUSED_APP = """
define stream S (sym string, v long);
@info(name='g1') from S#window.length(8) select sym, v insert into O1;
@info(name='g2') from S select sym, v insert into O2;
"""


@pytest.fixture(autouse=True)
def _off_after():
    yield
    for pkg in PKGS:
        a = api(pkg)
        a.journey.disable(force=True)
        a.instruments.disable(force=True)


def _collector(a):
    class Collector(a.StreamCallback):
        def __init__(self):
            super().__init__()
            self.rows = []

        def receive(self, events):
            self.rows.extend(tuple(e.data) for e in events)

    return Collector()


def _manager(a, extra=None):
    m = a.SiddhiManager()
    cfg = {"siddhi_tpu.pipeline_depth": "2"}
    cfg.update(extra or {})
    m.set_config_manager(a.InMemoryConfigManager(cfg))
    return m


def _feed_join(rt, n=24, keys=5):
    hl, hr = rt.get_input_handler("L"), rt.get_input_handler("R")
    for i in range(n):
        hl.send([f"S{i % keys}", i])
        hr.send([f"S{i % keys}", 100 + i])


def _both(scenario, *args):
    got = {pkg: scenario(api(pkg), *args) for pkg in PKGS}
    assert got["torch"] == got["jax"], got
    return got["torch"]


def _guard(a):
    if a.pkg == "jax":
        import jax

        return jax.transfer_guard("disallow")
    return no_tensor_reads()


# --------------------------------------------------- slots ride the meta


def _join_fill(a):
    m = _manager(a, {"siddhi_tpu.join_partitions": "8"})
    rt = m.create_siddhi_app_runtime(JOIN_APP)
    rt.add_callback("JOut", _collector(a))
    q = rt.query_runtimes["jq"]
    lanes = lane_recorder(q)
    _feed_join(rt)
    last = q._instr_last
    assert "fill.left" in last and "fill.right" in last
    assert last["fill.left"].shape == (8,) and int(last["fill.left"].sum()) > 0
    occ = q.engine.partition_occupancy("left")
    assert occ.tolist() == last["fill.left"].tolist()
    snap = rt.app_context.telemetry.snapshot()
    assert "device.jq.fill.left" in snap["gauges"]
    assert snap["gauges"]["device.jq.fill.left.capacity"] == q.engine.plans["left"].Wp
    assert "device.jq.fill.right" in snap.get("histograms", {})
    m.shutdown()
    return lanes


def test_join_fill_instrument_feeds_gauges_and_occupancy():
    assert _both(_join_fill)


def _scrape(a):
    m = _manager(a, {"siddhi_tpu.join_partitions": "8"})
    rt = m.create_siddhi_app_runtime(JOIN_APP)
    rt.add_callback("JOut", _collector(a))
    _feed_join(rt)
    with _guard(a):
        text = a.export.prometheus_text(m)
    assert "siddhi_join_partition_rows" in text and "siddhi_device_instrument" in text
    values = []
    for line in text.splitlines():
        if line.startswith(("siddhi_join_partition_rows", "siddhi_device_instrument{")):
            assert not line.endswith("NaN"), f"guarded gauge read a tensor: {line}"
            values.append((line.split("{", 1)[1].split("app=")[0],
                           float(line.rsplit(" ", 1)[1])))
    m.shutdown()
    assert values and sum(v for _k, v in values) > 0
    return sorted(values)


def test_scrape_zero_device_pulls_under_transfer_guard():
    _both(_scrape)


def _mirror(a):
    m = _manager(a, {"siddhi_tpu.join_partitions": "8",
                     "siddhi_tpu.profile_device_instruments": "false"})
    rt = m.create_siddhi_app_runtime(JOIN_APP)
    rt.add_callback("JOut", _collector(a))
    _feed_join(rt)
    q = rt.query_runtimes["jq"]
    assert not q._instr_last
    with _guard(a):
        occ = q.engine.partition_occupancy("left")
    m.shutdown()
    assert int(occ.sum()) == 24
    return occ.tolist()


def test_occupancy_host_mirror_fallback_with_knob_off():
    _both(_mirror)


def test_knob_off_meta_layouts_bit_for_bit():
    """Instruments off: the meta layouts are the port's before the
    instruments: [3] for a plain step, [4] for an engine join side
    (prefix and sequence), lane for lane the reference's on the same
    columns; with them on, the window's step carries its fill behind."""
    import jax
    import jax.numpy as jnp

    from siddhi_tpu.core.plan.selector_plan import GK_KEY
    from siddhi_tpu.ops.expressions import TS_KEY, TYPE_KEY, VALID_KEY

    extra = "\n@info(name='pq') from L#window.length(8) select sym, lv insert into POut;\n"
    B = 4
    cols = {TS_KEY: np.arange(B, dtype=np.int64), TYPE_KEY: np.zeros(B, np.int8),
            VALID_KEY: np.ones(B, bool), "sym": np.zeros(B, np.int64),
            "sym?": np.zeros(B, bool), "lv": np.arange(B, dtype=np.int64),
            "lv?": np.zeros(B, bool), GK_KEY: np.zeros(B, np.int32)}
    metas = {}
    for knob in ("false", "true"):
        for pkg in PKGS:
            a = api(pkg)
            m = _manager(a, {"siddhi_tpu.join_partitions": "8",
                             "siddhi_tpu.profile_device_instruments": knob})
            rt = m.create_siddhi_app_runtime(JOIN_APP + extra)
            jq, pq = rt.query_runtimes["jq"], rt.query_runtimes["pq"]
            spec = ([s.name for s in pq.instrument_slots()],
                    [s.name for s in jq.instrument_slots()])
            if pkg == "jax":
                _st, out = jax.jit(pq.build_step_fn())(pq._init_state(), dict(cols),
                                                       np.int64(0))
                pm = np.asarray(out["__meta__"])
                _st, out = jax.jit(jq.build_side_step_fn("left"))(
                    jq._init_state(), {}, jnp.zeros((1,), bool), dict(cols), np.int64(0))
                jm = np.asarray(out["__meta__"])
            else:
                tcols = {k: torch.from_numpy(v) for k, v in cols.items()}
                _st, out = pq.build_step_fn()(pq._init_state(), dict(tcols), 0)
                pm = out["__meta__"].numpy()
                _st, out = jq.build_side_step_fn("left")(
                    jq._init_state(), {}, torch.zeros((1,), dtype=torch.bool),
                    dict(tcols), 0)
                jm = out["__meta__"].numpy()
            m.shutdown()
            metas[(knob, pkg)] = (spec, pm.tolist(), jm.tolist())
        assert metas[(knob, "torch")] == metas[(knob, "jax")], metas
    spec, pm, jm = metas[("false", "torch")]
    assert spec == ([], ["seq"]) and len(pm) == 3 and len(jm) == 4
    spec, pm, jm = metas[("true", "torch")]
    assert spec == (["win_fill"], ["seq", "fill.left", "fill.right"])
    assert len(pm) == 4 and len(jm) == 4 + 2 * 8


def _refcount(a):
    m = _manager(a)
    rt = m.create_siddhi_app_runtime(
        "define stream S (sym string, v long);\n"
        "@info(name='q') from S select sym, v insert into Out;")
    rt.start()
    on = a.instruments.enabled()
    m2 = _manager(a)
    rt2 = m2.create_siddhi_app_runtime(
        "define stream S (sym string, v long);\n"
        "@info(name='q') from S select sym, v insert into Out;")
    rt2.start()
    m.shutdown()
    still = a.instruments.enabled()     # the second app holds its ref
    m2.shutdown()
    off = a.instruments.enabled()
    assert (on, still, off) == (True, True, False)
    return on, still, off


def test_refcounted_process_collector():
    _both(_refcount)


def _fused(a):
    m = _manager(a)
    rt = m.create_siddhi_app_runtime(FUSED_APP)
    c1, c2 = _collector(a), _collector(a)
    rt.add_callback("O1", c1)
    rt.add_callback("O2", c2)
    assert rt.fused_fanout_groups, "shape did not fuse"
    g1, g2 = rt.query_runtimes["g1"], rt.query_runtimes["g2"]
    lanes1, lanes2 = lane_recorder(g1), lane_recorder(g2)
    h = rt.get_input_handler("S")
    for i in range(20):
        h.send([f"K{i % 3}", i])
    assert g1._instr_last["win_fill"].tolist() == [8]
    assert not g2._instr_last
    assert len(c1.rows) and len(c2.rows) == 20
    m.shutdown()
    return lanes1, lanes2


def test_fused_members_decode_their_own_rows():
    lanes1, lanes2 = _both(_fused)
    assert [v for _n, v in lanes1][-1] == (8,) and lanes2 == []


# ------------------------------------------- planted saturated structures


def _hot_partition(a):
    m = _manager(a, {"siddhi_tpu.join_partitions": "8",
                     "siddhi_tpu.join_partition_grow": "false",
                     "siddhi_tpu.join_partition_slack": "2"})
    rt = m.create_siddhi_app_runtime(JOIN_APP)
    rt.add_callback("JOut", _collector(a))
    q = rt.query_runtimes["jq"]
    lanes = lane_recorder(q)
    hl, hr = rt.get_input_handler("L"), rt.get_input_handler("R")
    hl.send(["HOT", 0])
    a.journey.enable()
    try:
        for i in range(14):
            hr.send(["HOT", 100 + i])
        hl.send(["HOT", 1])
        rep = a.journey.critical_path_report(m)
        st = rep["apps"][rt.name]["queries"]["jq"].get("device_structure")
    finally:
        a.journey.disable(force=True)
    m.shutdown()
    assert st is not None and st["slot"] == "fill.right" and st["ratio"] >= 0.8, st
    assert "join right side partition fill" in st["text"] and "of Wp" in st["text"]
    return st, lanes


def test_report_names_hot_join_partition_at_growth_off_slack():
    _both(_hot_partition)


def _near_full(a):
    m = _manager(a)
    rt = m.create_siddhi_app_runtime(KEYED_APP)
    rt.add_callback("Out", _collector(a))
    q = rt.query_runtimes["kq"]
    lanes = lane_recorder(q)
    h = rt.get_input_handler("S")
    h.send(["A", 0.0])
    a.journey.enable()
    try:
        for i in range(20):
            h.send(["A", float(i)])
        rep = a.journey.critical_path_report(m)
        st = rep["apps"][rt.name]["queries"]["kq"].get("device_structure")
    finally:
        a.journey.disable(force=True)
    m.shutdown()
    assert st is not None and st["slot"] == "win_fill" and st["ratio"] >= 0.95, st
    assert "window ring fill" in st["text"]
    return st, lanes


def test_report_names_near_full_keyed_window():
    _both(_near_full)


def _verdict(a):
    dev = {"fill.right": {"snap": {"p99": 15.5, "count": 10, "sum": 150.0},
                          "capacity": 16.0}}
    stages = {
        "pack": {"service": {"sum": 5.0, "count": 10, "p99": 0.6}},
        "device": {"service": {"sum": 400.0, "count": 10, "p99": 45.0}},
        "emit": {"service": {"sum": 3.0, "count": 10, "p99": 0.4}},
    }
    rep = a.journey._query_report("app", "jq", stages, device_slots=dev)
    assert rep["bottleneck"]["stage"] == "device"
    assert "0.97 of Wp" in rep["bottleneck"]["structure"]
    return rep


def test_device_bottleneck_verdict_carries_structure():
    _both(_verdict)


# ----------------------------------------------- routed and NFA instruments


def _routed(a):
    m = _manager(a)
    rt = m.create_siddhi_app_runtime(ROUTED_APP)
    rt.add_callback("Out", _collector(a))
    q = rt.query_runtimes["rq"]
    a.device_route_query_step(q, a.make_mesh(4), rows_per_shard=64)
    lanes = lane_recorder(q)
    h = rt.get_input_handler("S")
    for i in range(80):
        h.send([f"P{i % 8}", float(i)])
    last = q._instr_last
    assert last["shard_rows"].shape == (4,)
    assert last["win_fill"].tolist() == [4]
    assert int(last["route_residual"][0]) <= 64 and int(last["groups"][0]) >= 1
    caps = dict(q._instr_caps)
    m.shutdown()
    assert caps["win_fill"] == 4.0
    return lanes, caps


def test_routed_instruments_aggregate_across_shards():
    lanes, _caps = _both(_routed)
    assert {n for n, _v in lanes} == {"shard_rows", "route_residual", "win_fill", "groups"}


def _nfa(a):
    m = _manager(a)
    rt = m.create_siddhi_app_runtime(NFA_APP)
    rt.add_callback("Out", _collector(a))
    q = rt.query_runtimes["nq"]
    lanes = lane_recorder(q)
    h = rt.get_input_handler("A")
    for i in range(10):
        h.send([f"N{i}", 11.0 + i])
    assert int(q._instr_last["nfa_runs"][0]) >= 1 and q._instr_caps["nfa_runs"] > 0
    caps = dict(q._instr_caps)
    m.shutdown()
    return lanes, caps


def test_nfa_runs_instrument():
    lanes, _caps = _both(_nfa)
    assert len(lanes) == 10


# --------------------------------------------------------- the program cache


def test_instruments_on_and_off_never_share_a_program():
    """Two apps of one program, one with device instruments off: their
    metas differ in layout, so they hold two program-cache entries; two
    apps with the knob equal share one."""
    from siddhi_tpu_torch.core.util import program_cache

    a = api("torch")
    app = ("@app:name('A{}') define stream S (sym string, v long);\n"
           "@info(name='q') from S#window.length(8) select sym, v insert into O;")

    def entries(knobs):
        program_cache.cache().drain()
        ms = []
        for i, knob in enumerate(knobs):
            m = _manager(a, {"siddhi_tpu.profile_device_instruments": knob})
            rt = m.create_siddhi_app_runtime(app.format(i))
            rt.get_input_handler("S").send(["a", 1])
            ms.append(m)
        snap = [e for e in program_cache.cache().snapshot()["entries"]
                if e["family"] == "query_step"]
        for m in ms:
            m.shutdown()
        return sorted(len(e["shared_by"]) for e in snap)

    assert entries(("true", "false")) == [1, 1]
    assert entries(("true", "true")) == [2]
    assert entries(("false", "false")) == [2]
    program_cache.cache().drain()


# ------------------------------------------------------------------ the card


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_replayed_lanes_equal_eager_lanes_on_the_card():
    """On the card the routed keyed window's step (the ring exchange
    inside) runs as a CUDA-graph replay a batch; the same app with its
    step held eager (``capturable`` False) decodes the same lanes
    (win_fill, groups, shard_rows, route_residual), batch for batch."""
    import siddhi_tpu_torch
    from siddhi_tpu_torch import InMemoryConfigManager
    from siddhi_tpu_torch.core.util import program_cache
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    program_cache.cache().drain()
    rng = np.random.default_rng(3)
    feed = [{"k": np.array([f"P{i}" for i in rng.integers(0, 50, 256)], dtype=object),
             "v": rng.random(256)} for _ in range(6)]
    runs = {}
    for captured in (True, False):
        m = siddhi_tpu_torch.SiddhiManager()
        m.set_config_manager(InMemoryConfigManager({"siddhi_tpu.program_cache": "false"}))
        rt = m.create_siddhi_app_runtime(ROUTED_APP)
        q = rt.query_runtimes["rq"]
        if not captured:
            q.capturable = lambda: False
        device_route_query_step(q, make_mesh(4), rows_per_shard=512)
        lanes = lane_recorder(q)
        h = rt.get_input_handler("S")
        for cols in feed:
            h.send_columns(cols)
        assert q.captured is captured
        if captured:
            assert q._step.graph.replays > 0
        m.shutdown()
        runs[captured] = lanes
    assert runs[True] == runs[False] and len(runs[True]) == 4 * len(feed)
