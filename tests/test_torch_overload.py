"""Overload control of the port (``resilience/overload.py``) against the
reference's: per-app queue quotas with the shed policies, the WAL discard
of a shed and a restore that replays exactly the suffix that was not
shed, the device-memory budget at each capacity-growth site (query key
capacity, routed key capacity, table capacity, aggregation buckets), the
pipeline quota, the config keys, the refused policy and the identity-
pinned unregistration.

The 20 plain scenarios of ``tests/test_overload.py`` drive the port
through the module's own feeds and checks (``torch_helpers.port_corpus``;
its one monkeypatched scenario has its counterpart in
``test_torch_supervisor.py``). The differential cases run one scenario
body through both packages (``torch_helpers.api``) and compare rows
(exactly; floats to rtol 1e-12), counters and denial messages. A worker
wedged by the fault injector makes every flood deterministic: nothing
drains while the producer floods. The port-only cases: the fair
scheduler, the ``/metrics`` families, per-app ``/query`` admission and
the shed's journey stamps. The routed denial's memory bound needs the
card (``cuda``)."""

import dataclasses
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torch_helpers import (  # noqa: F401 — release_jax_programs is an autouse fixture
    PARTITIONED_APP, api, assert_rows_match, port_corpus, release_jax_programs,
    send_feed, stock_feed)

MOD, SCENARIOS = port_corpus("test_overload")


def test_every_overload_scenario_is_collected():
    assert len(SCENARIOS) == 20, SCENARIOS


@pytest.mark.parametrize("name", SCENARIOS)
def test_overload_corpus_on_port(name):
    getattr(MOD, name)()


# ------------------------------------------------------------ both packages

def _ns(pkg):
    """``api(pkg)`` with the overload layer's names of that package."""
    ns = api(pkg)
    if pkg == "jax":
        from siddhi_tpu.core.stream.junction import FatalQueryError
        from siddhi_tpu.core.util.persistence import InMemoryPersistenceStore
        from siddhi_tpu.resilience import OverloadManager
    else:
        from siddhi_tpu_torch.core.stream.junction import FatalQueryError
        from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore
        from siddhi_tpu_torch.resilience import OverloadManager
    return types.SimpleNamespace(**vars(ns), FatalQueryError=FatalQueryError,
                                 InMemoryPersistenceStore=InMemoryPersistenceStore,
                                 OverloadManager=OverloadManager)


def _collector(ns):
    class C(ns.StreamCallback):
        def __init__(self):
            super().__init__()
            self.rows = []

        def receive(self, events):
            self.rows.extend((e.timestamp, tuple(e.data), e.is_expired) for e in events)

    return C()


def _wait_for(pred, timeout=15.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


ASYNC_APP = """
@app:name('{name}')
@Async(buffer.size='64')
define stream S (sym string, v long);
@info(name='q') from S select sym, v insert into Out;
"""


def _wedge_and_flood(ns, name, policy, seed):
    """A wedged worker parks one event; a seeded flood of single events
    then meets the queue quota of 4 under ``policy``; the worker is
    released and drains. Returns (rows, counters)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 10_000, 40).tolist()
    m = ns.SiddhiManager()
    rt = m.create_siddhi_app_runtime(ASYNC_APP.format(name=name))
    c = _collector(ns)
    rt.add_callback("Out", c)
    ctl = rt.enable_overload(queue_quota=4, shed_policy=policy)
    rt.start()
    inj = ns.FaultInjector()
    j = rt.junctions["S"]
    inj.wedge_worker(j)
    h = rt.get_input_handler("S")
    h.send(1, ["head", -1])
    assert inj.wait_wedged()
    for i, v in enumerate(vals):
        h.send(10 + i, [f"K{v % 5}", v])
    inj.release()
    assert _wait_for(lambda: len(c.rows) + ctl.shed_events == 41)
    tel = rt.app_context.telemetry.snapshot()["counters"]
    counts = {"shed_events": ctl.shed_events, "shed_units": ctl.shed_units,
              "junction": tel.get("junction.S.shed_events")}
    inj.clear()
    m.shutdown()
    return c.rows, counts


@pytest.mark.parametrize("policy", ["shed_newest", "shed_oldest"])
def test_shed_accounting_equals_the_reference(policy):
    got = _wedge_and_flood(_ns("torch"), f"shed_{policy}", policy, seed=7)
    want = _wedge_and_flood(_ns("jax"), f"shed_{policy}", policy, seed=7)
    assert_rows_match(got[0], want[0])
    assert got[1] == want[1]
    rows, counts = got
    assert counts["shed_events"] == counts["junction"] == 41 - len(rows) > 0
    # shed_newest keeps the oldest queued units, shed_oldest the freshest
    kept = [d[1] for _t, d, _e in rows[1:]]
    vals = np.random.default_rng(7).integers(0, 10_000, 40).tolist()
    assert kept == (vals[:len(kept)] if policy == "shed_newest" else vals[-len(kept):])


def _shed_restore(ns, seed):
    """Prefix delivered and persisted; a wedged worker and a flood under
    shed_oldest; then a fresh runtime restores and replays the WAL.
    Returns (live rows, WAL records after the flood, restored rows,
    replayed records, shed events)."""
    rng = np.random.default_rng(seed)
    store = ns.InMemoryPersistenceStore()
    m1 = ns.SiddhiManager()
    m1.set_persistence_store(store)
    rt1 = m1.create_siddhi_app_runtime(ASYNC_APP.format(name="walshed"))
    c1 = _collector(ns)
    rt1.add_callback("Out", c1)
    ctl = rt1.enable_overload(queue_quota=4, shed_policy="shed_oldest")
    wal = rt1.enable_wal()
    rt1.start()
    h = rt1.get_input_handler("S")
    for i in range(6):
        h.send(1000 + i, [f"K{i % 3}", int(rng.integers(0, 100))])
        assert _wait_for(lambda n=i: len(c1.rows) == n + 1)
    rt1.persist()
    inj = ns.FaultInjector()
    inj.wedge_worker(rt1.junctions["S"])
    h.send(2000, ["w", 100])
    assert inj.wait_wedged()
    for i in range(1, 20):
        h.send(2000 + i, [f"K{i % 3}", int(rng.integers(100, 200))])
    inj.release()
    assert _wait_for(lambda: len(c1.rows) + ctl.shed_events == 26)
    live, held, shed = c1.rows[6:], len(wal), ctl.shed_events
    inj.clear()
    m1.shutdown()
    m2 = ns.SiddhiManager()
    m2.set_persistence_store(store)
    rt2 = m2.create_siddhi_app_runtime(ASYNC_APP.format(name="walshed"))
    c2 = _collector(ns)
    rt2.add_callback("Out", c2)
    rt2.enable_overload(queue_quota=4, shed_policy="shed_oldest")
    rt2.app_context.ingest_wal = wal
    before = wal.replayed_batches
    assert rt2.restore_last_revision() is not None
    assert _wait_for(lambda: len(c2.rows) == len(live))
    time.sleep(0.2)       # nothing more may come: shed events stay shed
    restored = list(c2.rows)
    m2.shutdown()
    return live, held, restored, wal.replayed_batches - before, shed


def test_wal_discard_and_restore_replay_the_unshed_suffix_as_the_reference():
    got = _shed_restore(_ns("torch"), seed=3)
    want = _shed_restore(_ns("jax"), seed=3)
    live, held, restored, replayed, shed = got
    assert shed > 0 and held == len(live) == replayed == 20 - shed
    assert_rows_match(restored, live)
    assert_rows_match(live, want[0])
    assert_rows_match(restored, want[2])
    assert got[1::2] == want[1::2] and got[3] == want[3]


GROUP_APP = """
@app:name('membudget')
define stream S (sym string, v long);
@info(name='gq') from S select sym, sum(v) as t group by sym
  insert into Out;
"""
TABLE_APP = """
@app:name('tbudget')
define stream S (sym string, v long);
define table T (sym string, v long);
@info(name='ins') from S select sym, v insert into T;
"""
AGG_APP = """
@app:name('abudget')
define stream S (sym string, v long);
define aggregation AggT
  from S select sym, sum(v) as total group by sym
  aggregate every sec ... hour;
"""


def _key_growth(ns, budget_mb, seed):
    """10 keys, then 40 new ones (16 -> 64 key slots) under a budget.
    Returns (rows, denial message or None, charged bytes, denials)."""
    rng = np.random.default_rng(seed)
    m = ns.SiddhiManager()
    rt = m.create_siddhi_app_runtime(GROUP_APP)
    c = _collector(ns)
    rt.add_callback("Out", c)
    ctl = rt.enable_overload(memory_budget_mb=budget_mb)
    h = rt.get_input_handler("S")
    h.send_columns({"sym": [f"g{i}" for i in range(10)],
                    "v": rng.integers(0, 100, 10).tolist()},
                   timestamps=np.arange(10, dtype=np.int64))
    msg = None
    try:
        h.send_columns({"sym": [f"h{i}" for i in range(40)],
                        "v": rng.integers(0, 100, 40).tolist()},
                       timestamps=np.arange(10, 50, dtype=np.int64))
    except ns.FatalQueryError as e:
        msg = str(e)
    out = (c.rows, msg, ctl.charged_bytes(), ctl.quota_denials)
    m.shutdown()
    return out


def test_key_growth_denied_at_the_same_step_naming_the_knob():
    got = _key_growth(_ns("torch"), 0.0005, seed=1)
    want = _key_growth(_ns("jax"), 0.0005, seed=1)
    assert got[1] is not None and "(16->64 keys)" in got[1]
    assert "siddhi_tpu.quota_memory_mb" in got[1]
    assert got[1] == want[1]           # same step, bytes, budget and knob
    assert got[3] == want[3] == 1
    assert_rows_match(got[0], want[0])  # the first batch emitted, not the second


def test_generous_budget_charges_without_denying_as_the_reference():
    got = _key_growth(_ns("torch"), 256, seed=2)
    want = _key_growth(_ns("jax"), 256, seed=2)
    assert got[1] is None and got[3] == 0
    assert got[2] == want[2] > 0       # the grown state's bytes, charged
    assert_rows_match(got[0], want[0])


def _table_growth(ns):
    m = ns.SiddhiManager()
    rt = m.create_siddhi_app_runtime(TABLE_APP)
    ctl = rt.enable_overload(memory_budget_mb=0.000001)
    with pytest.raises(ns.FatalQueryError) as ei:
        rt.tables["T"]._ensure_room(5000)
    out = (str(ei.value), ctl.quota_denials, rt.tables["T"].capacity)
    m.shutdown()
    return out


def test_table_growth_denied_as_the_reference():
    got, want = _table_growth(_ns("torch")), _table_growth(_ns("jax"))
    assert "table 'T' capacity growth (1024->8192 rows)" in got[0]
    assert got == want                  # the capacity stays 1024


def _bucket_growth(ns, budget_mb):
    m = ns.SiddhiManager()
    rt = m.create_siddhi_app_runtime(AGG_APP)
    ctl = rt.enable_overload(memory_budget_mb=budget_mb)
    h = rt.get_input_handler("S")
    msg = None
    try:
        for i in range(6):
            h.send(1000 + 700 * i, [f"a{i % 3}", i])
    except ns.FatalQueryError as e:
        msg = str(e)
    out = (msg, ctl.quota_denials, ctl.charged_bytes())
    m.shutdown()
    return out


@pytest.mark.parametrize("budget_mb", [0.000001, 0.0015, 64])
def test_aggregation_bucket_growth_gated_as_the_reference(budget_mb):
    """A budget below the first fold's slots, one passed mid-feed and a
    generous one: the same fold denied (or none), the same ledger."""
    got, want = _bucket_growth(_ns("torch"), budget_mb), _bucket_growth(_ns("jax"), budget_mb)
    assert got == want
    if budget_mb < 1:
        assert "aggregation 'AggT' bucket-store growth" in got[0]
        assert "siddhi_tpu.quota_memory_mb" in got[0]
    else:
        assert got[0] is None and got[2] > 0


def _routed_growth(ns, budget_mb):
    """The routed flagship x4 (64 global key slots) fed 100 symbols: the
    growth to 128 global keys under a budget."""
    m = ns.SiddhiManager()
    rt = m.create_siddhi_app_runtime(PARTITIONED_APP.format(W=4))
    c = _collector(ns)
    rt.add_callback("OutStream", c)
    ns.device_route_query_step(rt.query_runtimes["bench"], ns.make_mesh(4),
                               rows_per_shard=64)
    ctl = rt.enable_overload(memory_budget_mb=budget_mb)
    msg = None
    try:
        send_feed(rt, "StockStream", stock_feed(11, 2, 128, 100))
    except ns.FatalQueryError as e:
        msg = str(e)
    out = (c.rows, msg, ctl.charged_bytes(), ctl.quota_denials)
    m.shutdown()
    return out


@pytest.mark.parametrize("budget_mb", [0.01, 64])
def test_routed_key_growth_gated_as_the_reference(budget_mb):
    got, want = _routed_growth(_ns("torch"), budget_mb), _routed_growth(_ns("jax"), budget_mb)
    assert_rows_match(got[0], want[0])
    assert got[1:] == want[1:]
    if budget_mb < 1:
        assert "routed key-capacity growth (64->128 global keys)" in got[1]
    else:
        assert got[1] is None and got[2] > 0


def _pipeline_rows(ns, quota, seed):
    rng = np.random.default_rng(seed)
    m = ns.SiddhiManager()
    m.set_config_manager(ns.InMemoryConfigManager({"siddhi_tpu.pipeline_depth": "8"}))
    rt = m.create_siddhi_app_runtime("""
        @app:name('pq')
        @Async(buffer.size='64')
        define stream S (sym string, v long);
        @Async(buffer.size='64')
        define stream T (sym string, v long);
        @info(name='a') from S#window.length(8) select sym, sum(v) as t
          group by sym insert into Out;
        @info(name='b') from T#window.length(8) select sym, count() as n
          group by sym insert into Out2;
    """)
    c, c2 = _collector(ns), _collector(ns)
    rt.add_callback("Out", c)
    rt.add_callback("Out2", c2)
    if quota is not None:
        rt.enable_overload(pipeline_quota=quota)
    hs, ht = rt.get_input_handler("S"), rt.get_input_handler("T")
    for i in range(12):
        syms = [f"K{k}" for k in rng.integers(0, 5, 8)]
        vals = rng.integers(0, 100, 8).tolist()
        ts = np.arange(8 * i, 8 * i + 8, dtype=np.int64)
        hs.send_columns({"sym": syms, "v": vals}, timestamps=ts)
        ht.send_columns({"sym": syms[::-1], "v": vals}, timestamps=ts)
    assert _wait_for(lambda: len(c.rows) == len(c2.rows) == 96)
    m.shutdown()
    return c.rows, c2.rows


def test_pipeline_quota_outputs_identical_to_unbounded_and_to_the_reference():
    bounded = _pipeline_rows(_ns("torch"), 1, seed=5)
    free = _pipeline_rows(_ns("torch"), None, seed=5)
    want = _pipeline_rows(_ns("jax"), 1, seed=5)
    for got, ref in zip(bounded + free, want + want):
        assert_rows_match(got, ref)


def _config(ns, keys):
    m = ns.SiddhiManager()
    m.set_config_manager(ns.InMemoryConfigManager(keys))
    rt = m.create_siddhi_app_runtime(ASYNC_APP.format(name="cfg"))
    ctl = rt.app_context.overload
    out = None if ctl is None else (dataclasses.asdict(ctl.config),
                                    ctl.policy_of(rt.junctions["S"]), ctl.query_cap)
    m.shutdown()
    return out


@pytest.mark.parametrize("keys", [
    {"siddhi_tpu.quota_queue_depth": "16", "siddhi_tpu.shed_policy": "shed_oldest",
     "siddhi_tpu.shed_policy.S": "shed_newest", "siddhi_tpu.quota_pipeline_depth": "8",
     "siddhi_tpu.quota_memory_mb": "128", "siddhi_tpu.fair_weight": "2.5",
     "siddhi_tpu.quota_query_cap": "32", "siddhi_tpu.quota_block_timeout_s": "0.5"},
    {"siddhi_tpu.quota_queue_depth.S": "0"},
    {"siddhi_tpu.fair_weight": "0"},
    {"siddhi_tpu.pipeline_depth": "4"},
])
def test_config_keys_register_the_reference_control(keys):
    got, want = _config(_ns("torch"), keys), _config(_ns("jax"), keys)
    assert got == want
    assert (got is None) == (keys == {"siddhi_tpu.pipeline_depth": "4"})


def _bad_policy(ns):
    m = ns.SiddhiManager()
    rt = m.create_siddhi_app_runtime(ASYNC_APP.format(name="badpolicy"))
    with pytest.raises(ValueError) as ei:
        rt.enable_overload(queue_quota=4, shed_policy="drop_everything")
    out = (str(ei.value), rt.app_context.overload)
    m.shutdown()
    return out


def test_bad_shed_policy_refused_as_the_reference():
    got, want = _bad_policy(_ns("torch")), _bad_policy(_ns("jax"))
    assert got[0] == want[0] and "drop_everything" in got[0]
    assert got[1] is None and want[1] is None


def _blue_green(ns):
    m_old, m_new = ns.SiddhiManager(), ns.SiddhiManager()
    rt_old = m_old.create_siddhi_app_runtime(ASYNC_APP.format(name="bgd"))
    ctl_old = rt_old.enable_overload(queue_quota=8)
    rt_new = m_new.create_siddhi_app_runtime(ASYNC_APP.format(name="bgd"))
    ctl_new = rt_new.enable_overload(queue_quota=16)
    mgr = ns.OverloadManager.instance()
    steps = [mgr.control_of("bgd") is ctl_new, ctl_new is not ctl_old]
    m_old.shutdown()
    steps += [mgr.control_of("bgd") is ctl_new, rt_new.app_context.overload is ctl_new,
              rt_old.app_context.overload is None]
    m_new.shutdown()
    steps.append(mgr.control_of("bgd") is None)
    return steps


def test_newer_same_named_registration_survives_the_old_shutdown():
    got, want = _blue_green(_ns("torch")), _blue_green(_ns("jax"))
    assert got == want == [True] * 6


# --------------------------------------------------------------- port only

def test_quotas_off_leave_no_control_and_generous_quotas_keep_the_rows():
    """No key: ``app_context.overload`` is None and no gauge or counter
    of the layer exists. Generous quotas of every kind: the same rows."""
    ns = _ns("torch")

    def run(quotas):
        m = ns.SiddhiManager()
        rt = m.create_siddhi_app_runtime(
            "@app:name('flag')\n@Async(buffer.size='64')\n"
            + PARTITIONED_APP.format(W=16))
        c = _collector(ns)
        rt.add_callback("OutStream", c)
        if quotas:
            rt.enable_overload(queue_quota=64, shed_policy="shed_oldest",
                               pipeline_quota=64, memory_budget_mb=1024,
                               fair_weight=3.0, query_cap=64)
        send_feed(rt, "StockStream", stock_feed(4, 4, 64, 40))
        tel = rt.app_context.telemetry.snapshot()
        off = rt.app_context.overload is None
        m.shutdown()
        return c.rows, off, tel

    rows_off, off, tel = run(False)
    rows_on, on_off, tel_on = run(True)
    assert off and not on_off
    assert not any(k.startswith("quota.") for k in tel["gauges"])
    assert "quota.memory_utilization" in tel_on["gauges"]
    assert rows_on == rows_off and len(rows_off) == 256


def test_fair_scheduler_weights_and_decay():
    from siddhi_tpu_torch.resilience.overload import FairScheduler

    fs = FairScheduler(tau_s=10.0)
    fs.register("heavy", 3.0, lambda: 0)
    fs.register("light", 1.0, lambda: 5)         # backlogged
    # at 3x the weight, 3x the usage is the fair share: no yield
    fs.throttle("light", 1_000)
    assert fs.throttle("heavy", 3_000) == 0.0
    # far past it, while the sibling is backlogged: a bounded yield
    for _ in range(4):
        d = fs.throttle("heavy", 50_000)
    assert 0.0 < d <= FairScheduler._MAX_SLEEP_S
    # an unregistered name pays nothing; a dead backlog probe is ignored
    assert fs.throttle("ghost", 10) == 0.0
    fs.register("light", 1.0, lambda: 1 / 0)
    assert fs.throttle("heavy", 50_000) == 0.0
    # decay: after many time constants the history is gone
    fs = FairScheduler(tau_s=0.01)
    fs.register("a", 1.0, lambda: 0)
    fs.register("b", 1.0, lambda: 1)
    fs.throttle("a", 10_000)
    time.sleep(0.3)
    fs.throttle("b", 10)
    assert fs.throttle("a", 1) == 0.0


def test_metrics_predeclare_the_counters_and_render_quota_and_shed_families():
    from siddhi_tpu_torch.observability.export import prometheus_text

    ns = _ns("torch")
    rows, counts = _wedge_and_flood(ns, "shedmetrics_run", "shed_newest", seed=9)
    m = ns.SiddhiManager()
    rt = m.create_siddhi_app_runtime(ASYNC_APP.format(name="metrics_port"))
    ctl = rt.enable_overload(queue_quota=4, shed_policy="shed_newest",
                             pipeline_quota=4, memory_budget_mb=64)
    rt.start()
    inj = ns.FaultInjector()
    inj.wedge_worker(rt.junctions["S"])
    h = rt.get_input_handler("S")
    h.send(["a", 0])
    assert inj.wait_wedged()
    for i in range(10):
        h.send([f"K{i}", i])
    text = prometheus_text(m)
    for name in ("resilience.worker_restarts", "resilience.pump_wedges",
                 "resilience.shed_events", "resilience.quota_denials",
                 "resilience.enqueue_timeouts"):
        assert f'siddhi_counter_total{{app="metrics_port",name="{name}"}} 0' in text, name
    assert 'siddhi_quota_utilization{app="metrics_port",resource="queue",stream="S"} 1' in text
    assert 'siddhi_quota_utilization{app="metrics_port",resource="pipeline"}' in text
    assert 'siddhi_quota_utilization{app="metrics_port",resource="memory"} 0' in text
    assert (f'siddhi_junction_shed_events_total{{app="metrics_port",stream="S"}} '
            f'{ctl.shed_events}') in text and ctl.shed_events == 6
    # the supervisor's peer counters are declared at 0 as well
    for name in ("resilience.peer_failures", "resilience.peer_recoveries"):
        assert f'siddhi_counter_total{{app="metrics_port",name="{name}"}} 0' in text, name
    inj.clear()
    m.shutdown()
    assert counts["shed_events"] == 41 - len(rows)


def test_shed_oldest_evictions_leave_no_journey_stamp_or_wal_seq():
    """A unit evicted by shed_oldest takes its queue-residence stamp and
    its WAL sequence number with it."""
    from siddhi_tpu_torch.observability import journey

    ns = _ns("torch")
    m = ns.SiddhiManager()
    rt = m.create_siddhi_app_runtime(ASYNC_APP.format(name="stamps"))
    c = _collector(ns)
    rt.add_callback("Out", c)
    ctl = rt.enable_overload(queue_quota=4, shed_policy="shed_oldest")
    wal = rt.enable_wal()
    rt.start()
    j = rt.junctions["S"]
    inj = ns.FaultInjector()
    journey.enable()
    try:
        inj.wedge_worker(j)
        h = rt.get_input_handler("S")
        h.send(1, ["head", 0])
        assert inj.wait_wedged()
        for i in range(30):
            h.send(2 + i, [f"K{i % 3}", i])
        assert ctl.shed_events == 26
        assert len(j._jt_enq) == len(j._wal_seq_of) == 4 == j._queue.qsize()
        assert len(wal) == 5
        inj.release()
        assert _wait_for(lambda: len(c.rows) == 5)
        assert j._jt_enq == {} and j._wal_seq_of == {}
    finally:
        journey.disable(force=True)
        inj.clear()
        m.shutdown()


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="POST",
        data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_query_cap_sheds_one_app_on_its_own_endpoint_while_a_sibling_answers():
    from siddhi_tpu_torch.service import SiddhiRestService

    ns = _ns("torch")
    m = ns.SiddhiManager()
    svc = SiddhiRestService(m, query_workers=2, query_queue_cap=8).start()
    try:
        for name in ("Hot", "Cold"):
            m.create_siddhi_app_runtime(
                f"@app:name('{name}') @app:statistics('true') define stream S (v long); "
                "define table T (v long); from S insert into T;").start()
        hot = m.get_siddhi_app_runtime("Hot")
        hot.enable_overload(query_cap=1)
        gate = threading.Event()
        orig = hot.query
        hot.query = lambda q: (gate.wait(10), orig(q))[1]
        codes = []
        first = threading.Thread(target=lambda: codes.append(
            _post(svc.port, "/query", {"app": "Hot", "query": "from T select v"})))
        first.start()
        pool = svc.admission
        assert _wait_for(lambda: pool._pending.get("/query:Hot", 0) == 1)
        for _ in range(2):
            codes.append(_post(svc.port, "/query", {"app": "Hot", "query": "from T select v"}))
        cold = _post(svc.port, "/query", {"app": "Cold", "query": "from T select v"})
        assert codes == [503, 503] and cold == 200
        assert pool._pending.get("/query", 0) == 0
        gate.set()
        first.join(30)
        assert codes == [503, 503, 200]
        assert hot.statistics()["counters"]["resilience.query_sheds"] == 2
        assert m.get_siddhi_app_runtime("Cold").statistics().get(
            "counters", {}).get("resilience.query_sheds", 0) == 0
    finally:
        svc.stop()
        m.shutdown()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_routed_growth_denied_before_allocation_on_the_card():
    """The routed flagship x4 on the card, 1,024 global key slots, fed
    2,000 symbols under a budget of 1.5 times its state (the growth to
    2,048 keys projects twice it): denied with no allocation past the
    state (peak memory below the state plus its projected growth), the
    old state kept; the same under a generous budget grows and charges
    the grown state's bytes."""
    import siddhi_tpu_torch
    from siddhi_tpu_torch.core.stream.junction import FatalQueryError
    from siddhi_tpu_torch.core.util.statistics import pytree_nbytes
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    def build(budget_mb):
        m = siddhi_tpu_torch.SiddhiManager(device="cuda")
        rt = m.create_siddhi_app_runtime(PARTITIONED_APP.format(W=1000))
        q = rt.query_runtimes["bench"]
        q.selector_plan.num_keys = q._win_keys = 1024
        device_route_query_step(q, make_mesh(4), rows_per_shard=4096)
        rt.get_input_handler("StockStream").send_columns(
            {"symbol": np.array([f"s{i}" for i in range(8)], dtype=object),
             "price": np.ones(8, np.float32), "volume": np.ones(8, np.int64)})
        ctl = rt.enable_overload(memory_budget_mb=budget_mb)
        return m, rt, q, ctl

    feed = {"symbol": np.array([f"s{i % 2000}" for i in range(8192)], dtype=object),
            "price": np.ones(8192, np.float32), "volume": np.ones(8192, np.int64)}
    m, rt, q, ctl = build(1)
    nbytes = pytree_nbytes(q._state)
    rt.enable_overload(memory_budget_mb=1.5 * nbytes / 2**20)
    state, step = q._state, q._step
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with pytest.raises(FatalQueryError, match="siddhi_tpu.quota_memory_mb"):
        rt.get_input_handler("StockStream").send_columns(feed)
    assert torch.cuda.max_memory_allocated() < base + 2 * nbytes
    assert q._state is state and q._step is step and ctl.quota_denials == 1
    m.shutdown()
    m, rt, q, ctl = build(4096)
    rt.get_input_handler("StockStream").send_columns(feed)
    assert ctl.quota_denials == 0 and ctl.charged_bytes() == pytree_nbytes(q._state)
    m.shutdown()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_two_async_streams_capture_their_first_batches_together_on_the_card():
    """Two @Async streams of one app meet their first batch at once, so
    their workers capture their steps' graphs together (captures are
    serialized process-wide); at depth 8, unbounded and under
    ``quota_pipeline_depth`` 2, every row equals a synchronous run's."""
    import siddhi_tpu_torch

    app = """
    @app:name('twostreams')
    {ann}define stream A (symbol string, price float, volume long);
    {ann}define stream B (symbol string, price float, volume long);
    @info(name = 'qa') from A#window.length(64)
    select symbol, avg(price) as ap, sum(volume) as tv group by symbol insert into OA;
    @info(name = 'qb') from B#window.length(64)
    select symbol, distinctCount(volume) as dv group by symbol insert into OB;
    """
    feed = stock_feed(8, 6, 4096, 300)

    def run(asynchronous, knobs):
        m = siddhi_tpu_torch.SiddhiManager(device="cuda")
        m.set_config_manager(siddhi_tpu_torch.InMemoryConfigManager(knobs))
        rt = m.create_siddhi_app_runtime(
            app.format(ann="@Async(buffer.size='64')\n    " if asynchronous else ""))
        ca, cb = _collector(_ns("torch")), _collector(_ns("torch"))
        rt.add_callback("OA", ca)
        rt.add_callback("OB", cb)
        ha, hb = rt.get_input_handler("A"), rt.get_input_handler("B")
        for _kind, cols, ts in feed:
            ha.send_columns(cols, timestamps=ts)
            hb.send_columns(cols, timestamps=ts)
        assert _wait_for(lambda: len(ca.rows) == len(cb.rows) == 6 * 4096, 60.0)
        captured = all(q.captured for q in rt.query_runtimes.values())
        m.shutdown()
        return ca.rows, cb.rows, captured

    want = run(False, {"siddhi_tpu.pipeline_depth": "1"})
    for knobs in ({"siddhi_tpu.pipeline_depth": "8"},
                  {"siddhi_tpu.pipeline_depth": "8", "siddhi_tpu.quota_pipeline_depth": "2"}):
        got = run(True, knobs)
        assert got[2] and got[:2] == want[:2], knobs
