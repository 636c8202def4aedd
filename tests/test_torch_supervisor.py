"""The app supervisor of the port (``resilience/supervisor.py``) against
the reference's observable results: a wedged @Async worker replaced with
every batch delivered once and in order, a killed worker restarted, dead
ingest packers healed, a producer's blocked enqueue escalated to the
supervisor (with and without quotas), the pipeline's wedge check counted
once an episode, and the peer half: a peer failure counted and
recovered once. Each scenario body runs through both packages
(``torch_helpers.api``); the wedge under CUDA-graph replays needs the
card (``cuda``)."""

import time
import types

import numpy as np
import pytest
import torch

from torch_helpers import api, assert_rows_match, release_jax_programs  # noqa: F401


def _ns(pkg):
    ns = api(pkg)
    if pkg == "jax":
        import siddhi_tpu.resilience.overload as overload
        from siddhi_tpu.core.event import HostBatch
    else:
        import siddhi_tpu_torch.resilience.overload as overload
        from siddhi_tpu_torch.core.event import HostBatch
    return types.SimpleNamespace(**vars(ns), HostBatch=HostBatch, overload=overload)


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


BOTH = ["jax", "torch"]

APP_ASYNC = """
@app:name('asyncApp')
@Async(buffer.size='512', batch.size='32')
define stream S (sym string, v long);
@info(name = 'q')
from S select sym, v insert into Out;
"""


def _wedged_worker(ns):
    m = ns.SiddhiManager()
    rt = m.create_siddhi_app_runtime(APP_ASYNC)
    c = _collector(ns)
    rt.add_callback("Out", c)
    h = rt.get_input_handler("S")
    h.send(1, ["warm", 0])
    assert _wait_for(lambda: len(c.rows) == 1)
    sup = rt.supervise(interval_s=0.05, wedge_timeout_s=0.4)
    inj = ns.FaultInjector()
    j = rt.junctions["S"]
    try:
        inj.wedge_worker(j)
        assert inj.wait_wedged(10.0)          # stuck, alive
        for i in range(50):
            h.send(10 + i, [f"K{i % 4}", i])  # piles into the queue
        assert _wait_for(lambda: sup.worker_restarts >= 1)
        assert _wait_for(lambda: len(c.rows) == 51), len(c.rows)
        inj.release()                         # the stale worker retires
        time.sleep(0.3)
        return c.rows, sup.worker_restarts, j._gen
    finally:
        inj.clear()
        m.shutdown()


def test_wedged_async_worker_is_replaced_without_loss_or_dup():
    got, want = _wedged_worker(_ns("torch")), _wedged_worker(_ns("jax"))
    assert [d[1] for _t, d, _e in got[0][1:]] == list(range(50))   # once, in order
    assert_rows_match(got[0], want[0])
    assert got[1:] == want[1:] == (1, 2)


def _killed_worker(ns):
    m = ns.SiddhiManager()
    rt = m.create_siddhi_app_runtime(APP_ASYNC)
    c = _collector(ns)
    rt.add_callback("Out", c)
    h = rt.get_input_handler("S")
    h.send(1, ["warm", 0])
    assert _wait_for(lambda: len(c.rows) == 1)
    rt.set_statistics_level("basic")
    sup = rt.supervise(interval_s=0.05, wedge_timeout_s=5.0)
    inj = ns.FaultInjector()
    j = rt.junctions["S"]
    before = j._worker
    try:
        inj.kill_worker(j)
        assert _wait_for(lambda: not before.is_alive())
        assert _wait_for(lambda: sup.worker_restarts >= 1)
        for i in range(20):
            h.send(10 + i, [f"K{i % 4}", i])
        assert _wait_for(lambda: len(c.rows) == 21), len(c.rows)
        # the tick adds the statistic after it restarts the worker
        assert _wait_for(lambda: rt.statistics().get("counters", {}).get(
            "resilience.worker_restarts", 0) >= 1)
        counters = rt.statistics().get("counters", {})
        return c.rows, sup.worker_restarts, counters.get("resilience.worker_restarts")
    finally:
        inj.clear()
        m.shutdown()


def test_killed_async_worker_is_restarted():
    got, want = _killed_worker(_ns("torch")), _killed_worker(_ns("jax"))
    assert [d[1] for _t, d, _e in got[0][1:]] == list(range(20))
    assert_rows_match(got[0], want[0])
    assert got[1:] == want[1:] == (1, 1)


POOL_APP = """
@app:enforceOrder
define stream S (sym string, v double, n long);
@info(name='q') from S#window.length(64)
  select sym, sum(v) as sv, count() as c group by sym
  insert into Out;
"""


def _healed_packers(ns):
    m = ns.SiddhiManager()
    m.set_config_manager(ns.InMemoryConfigManager(
        {"siddhi_tpu.ingest_pool": "2", "siddhi_tpu.ingest_split": "128"}))
    rt = m.create_siddhi_app_runtime(POOL_APP)
    c = _collector(ns)
    rt.add_callback("Out", c)
    rt.start()
    sup = rt.supervise(interval_s=0.05)
    pool = rt.app_context.ingest_pack_pool
    inj = ns.FaultInjector()
    inj.kill_packer(pool)
    rt.get_input_handler("S").send(
        [ns.Event(timestamp=i, data=[f"K{i % 9}", 1.0, i]) for i in range(1000)])
    assert _wait_for(lambda: pool.alive_workers() == 2, 5.0)
    out = (c.rows, pool.alive_workers(), pool.worker_deaths, pool._beats >= 1)
    inj.clear()
    sup.stop()
    m.shutdown()
    return out


def test_supervisor_heals_dead_packers():
    got, want = _healed_packers(_ns("torch")), _healed_packers(_ns("jax"))
    assert got[1:] == want[1:] == (2, 1, True)
    assert_rows_match(got[0], want[0])
    assert len(got[0]) == 1000


def test_heal_respawns_at_the_tick_without_a_submit():
    """The tick alone brings a dead packer back: the killed worker's task
    is queued by hand, so no merging thread respawns it first."""
    from siddhi_tpu_torch.core.stream.input.pack_pool import _Task

    ns = _ns("torch")
    m = ns.SiddhiManager()
    m.set_config_manager(ns.InMemoryConfigManager({"siddhi_tpu.ingest_pool": "3"}))
    rt = m.create_siddhi_app_runtime(POOL_APP)
    rt.start()
    pool = rt.app_context.ingest_pack_pool
    inj = ns.FaultInjector()
    inj.kill_packer(pool)
    task = _Task(0, 0, 1, lambda lo, hi: None)
    pool._tasks.put(task)
    assert task.done.wait(5.0) and task.error is not None
    assert _wait_for(lambda: pool.alive_workers() == 2, 5.0)
    assert pool.worker_deaths == 1
    rt.set_statistics_level("basic")
    sup = rt.supervise(interval_s=0.05)
    try:
        assert _wait_for(lambda: pool.alive_workers() == 3, 5.0)
        # the tick counts the respawn after heal() returns: wait for the
        # counts, not only for the thread
        assert _wait_for(lambda: sup.worker_restarts == 1 and rt.statistics()[
            "counters"].get("resilience.worker_restarts") == 1, 5.0)
        assert sup.worker_restarts == 1
        assert rt.statistics()["counters"]["resilience.worker_restarts"] == 1
        assert pool.heal() == 0
    finally:
        inj.clear()
        m.shutdown()


QUOTA_APP = """
@app:name('{name}')
@Async(buffer.size='{buf}')
define stream S (sym string, v long);
@info(name='q') from S select sym, v insert into Out;
"""


def _blocked_escalates(ns, with_quota):
    m = ns.SiddhiManager()
    rt = m.create_siddhi_app_runtime(QUOTA_APP.format(
        name="blocker" if with_quota else "defbound", buf=64 if with_quota else 2))
    c = _collector(ns)
    rt.add_callback("Out", c)
    ctl = (rt.enable_overload(queue_quota=2, shed_policy="block", block_timeout_s=0.4)
           if with_quota else None)
    # a long interval: a restart can come only from the escalation
    sup = rt.supervise(interval_s=60.0, wedge_timeout_s=0.3)
    rt.start()
    inj = ns.FaultInjector()
    inj.wedge_worker(rt.junctions["S"])
    h = rt.get_input_handler("S")
    h.send(1, ["a", 0])
    assert inj.wait_wedged()
    t0 = time.time()
    for i in range(1, 6):           # past the quota (or buffer): they block
        h.send(1 + i, [f"K{i}", i])
    elapsed = time.time() - t0
    assert _wait_for(lambda: len(c.rows) == 6), len(c.rows)
    tel = rt.app_context.telemetry.snapshot()["counters"]
    out = (c.rows, elapsed < 20.0, sup.worker_restarts >= 1,
           tel.get("junction.S.enqueue_timeouts", 0) >= 1,
           ctl.enqueue_timeouts >= 1 if ctl is not None else None,
           rt.app_context.overload is None)
    inj.clear()
    m.shutdown()
    return out


def test_block_policy_escalates_to_supervisor_and_unblocks():
    got = _blocked_escalates(_ns("torch"), with_quota=True)
    want = _blocked_escalates(_ns("jax"), with_quota=True)
    assert [d[1] for _t, d, _e in got[0]] == list(range(6))   # order kept
    assert_rows_match(got[0], want[0])
    assert got[1:] == want[1:] == (True, True, True, True, False)


@pytest.mark.parametrize("pkg", BOTH)
def test_bounded_enqueue_escalates_without_overload_config(pkg, monkeypatch):
    """The blocking put is bounded without quotas too: a full buffer with
    a wedged worker escalates to the supervisor instead of parking the
    producer forever. The same observable results in both packages."""
    ns = _ns(pkg)
    monkeypatch.setattr(ns.overload, "DEFAULT_BLOCK_TIMEOUT_S", 0.5)
    monkeypatch.setattr(ns.overload, "BLOCK_PUT_SLICE_S", 0.1)
    rows, fast, restarted, timeouts, _ctl, off = _blocked_escalates(ns, with_quota=False)
    assert (fast, restarted, timeouts, off) == (True, True, True, True)
    assert [d[1] for _t, d, _e in rows] == list(range(6))


PUMP_APP = """
@app:name('pumpApp')
define stream S (sym string, v long);
@info(name='pq')
from S#window.length(8)
  select sym, sum(v) as total group by sym
  insert into Out;
"""


def _pump_wedge(ns):
    """Batches parked in the pump by direct dispatch (nothing drains them,
    as a hung step's meta never arrives): the wedge check counts once an
    episode, and once they drain a later stall is a new episode."""
    m = ns.SiddhiManager()
    m.set_config_manager(ns.InMemoryConfigManager({"siddhi_tpu.pipeline_depth": "4"}))
    rt = m.create_siddhi_app_runtime(PUMP_APP)
    c = _collector(ns)
    rt.add_callback("Out", c)
    rt.start()
    rt.set_statistics_level("basic")
    qr = rt.query_runtimes["pq"]
    pump = rt.app_context.completion_pump
    defn = rt.junctions["S"].definition

    def park(vals, ts0):
        qr.receive_batch(ns.HostBatch.from_columns(
            {"sym": np.array(["A"] * len(vals), dtype=object),
             "v": np.asarray(vals, np.int64)},
            defn, rt.app_context.string_dictionary,
            timestamps=np.arange(ts0, ts0 + len(vals), dtype=np.int64)))

    sup = rt.supervise(interval_s=0.05, wedge_timeout_s=0.4)
    try:
        assert pump.oldest_age_s() is None
        park([1], 0)
        park([2], 1)
        assert _wait_for(lambda: sup.pump_wedges == 1)
        time.sleep(0.5)
        steps = [sup.pump_wedges, len(c.rows), pump.oldest_age_s() > 0.4]
        pump.flush()
        time.sleep(0.2)               # a tick sees the pump empty
        park([4], 2)
        assert _wait_for(lambda: sup.pump_wedges == 2)
        # the tick logs, then counts the statistic, after pump_wedges
        assert _wait_for(lambda: rt.statistics()["counters"].get(
            "resilience.pump_wedges") == 2)
        pump.flush()
        counters = rt.statistics()["counters"]
        steps += [sup.pump_wedges, counters.get("resilience.pump_wedges"),
                  sup.worker_restarts]
        return c.rows, steps
    finally:
        m.shutdown()


def test_pump_wedge_counted_once_an_episode():
    got, want = _pump_wedge(_ns("torch")), _pump_wedge(_ns("jax"))
    assert got[1] == want[1] == [1, 0, True, 2, 2, 0]
    assert_rows_match(got[0], want[0])
    assert [d for _t, d, _e in got[0]] == [("A", 1), ("A", 3), ("A", 7)]


def test_peer_recovery_arguments_refused_naming_a9():
    """The peer half of the supervisor (it refused its arguments until the
    port had the cluster): ``supervise`` takes ``peer_recovery`` and
    ``peer_monitor``; ``notify_error`` counts ``resilience.peer_failures``
    for a ``ClusterPeerError`` and nothing for an app-level "reset by
    peer" error, and runs the recovery once; the new runtime counts
    ``resilience.peer_recoveries``. Both packages give the same counts."""
    got = {}
    for pkg in BOTH:
        ns = _ns(pkg)
        if pkg == "jax":
            from siddhi_tpu.core.util.persistence import InMemoryPersistenceStore
            from siddhi_tpu.parallel.distributed import ClusterPeerError
            from siddhi_tpu.resilience.supervisor import PeerMonitor, PeerRecovery
        else:
            from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore
            from siddhi_tpu_torch.parallel.distributed import ClusterPeerError
            from siddhi_tpu_torch.resilience.supervisor import PeerMonitor, PeerRecovery
        m = ns.SiddhiManager()
        m.set_persistence_store(InMemoryPersistenceStore())
        m.set_config_manager(ns.InMemoryConfigManager(
            {"siddhi_tpu.statistics": "BASIC"}))
        rt = m.create_siddhi_app_runtime("@app:statistics('BASIC') " + APP_ASYNC)
        built = []

        def rebuild(m=m):
            new = m.create_siddhi_app_runtime("@app:statistics('BASIC') " + APP_ASYNC)
            built.append(new)
            return new

        monitor = PeerMonitor()
        try:
            sup = rt.supervise(interval_s=60.0, peer_recovery=PeerRecovery(rebuild),
                               peer_monitor=monitor)
            assert rt.supervise() is sup                # idempotent
            assert sup.peer_monitor is monitor
            j = rt.junctions["S"]
            assert sup.notify_error(j, RuntimeError("reset by peer")) is None
            sup.notify_error(j, ClusterPeerError("peer gone"))
            sup.notify_error(j, ClusterPeerError("peer gone again"))
            new_rt, revision = sup.wait_recovered(30.0)
            assert new_rt is built[0] and revision is None and len(built) == 1
            counters = rt.statistics().get("counters", {})
            got[pkg] = (counters.get("resilience.peer_failures"),
                        new_rt.statistics().get("counters", {}).get(
                            "resilience.peer_recoveries"))
            sup.stop()
            assert rt.app_context.supervisor is None
        finally:
            m.shutdown()
    assert got["torch"] == got["jax"] == (2, 1)


def test_supervisor_leaves_a_healthy_slow_worker_alone():
    """A worker that keeps beating is not replaced, however long its
    deliveries take; a backpressure escalation over it returns False."""
    ns = _ns("torch")
    m = ns.SiddhiManager()
    rt = m.create_siddhi_app_runtime(APP_ASYNC)
    c = _collector(ns)
    rt.add_callback("Out", c)
    rt.start()
    sup = rt.supervise(interval_s=0.05, wedge_timeout_s=0.3)
    inj = ns.FaultInjector()
    j = rt.junctions["S"]
    try:
        inj.delay_worker(j, 0.05, persistent=True)   # slow, beating
        h = rt.get_input_handler("S")
        for i in range(10):
            h.send(i, [f"K{i}", i])
        assert _wait_for(lambda: len(c.rows) == 10)
        assert sup.notify_backpressure(j) is False
        assert sup.worker_restarts == 0 and j._gen == 1
    finally:
        inj.clear()
        m.shutdown()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_wedge_under_graph_replays_on_the_card():
    """The @Async global flagship on the card at depth 4, its step a
    CUDA-graph replay a batch: a worker wedged mid-feed is replaced and
    the rows equal an unfaulted run's bit for bit."""
    import siddhi_tpu_torch
    from torch_helpers import send_feed, stock_feed

    app = """
    @app:name('gw')
    @Async(buffer.size='64')
    define stream StockStream (symbol string, price float, volume long);
    @info(name = 'bench')
    from StockStream#window.length(64)
    select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
    group by symbol insert into OutStream;
    """
    feed = stock_feed(6, 8, 4096, 200)

    def run(wedge):
        m = siddhi_tpu_torch.SiddhiManager(device="cuda")
        m.set_config_manager(siddhi_tpu_torch.InMemoryConfigManager(
            {"siddhi_tpu.pipeline_depth": "4"}))
        rt = m.create_siddhi_app_runtime(app)
        c = _collector(_ns("torch"))
        rt.add_callback("OutStream", c)
        sup = rt.supervise(interval_s=0.05, wedge_timeout_s=0.4)
        inj = siddhi_tpu_torch.resilience.FaultInjector()
        send_feed(rt, "StockStream", feed[:4])
        if wedge:
            inj.wedge_worker(rt.junctions["StockStream"])
            assert inj.wait_wedged(10.0)
        send_feed(rt, "StockStream", feed[4:])
        assert _wait_for(lambda: len(c.rows) == 8 * 4096, 60.0)
        inj.release()
        q = rt.query_runtimes["bench"]
        out = (c.rows, sup.worker_restarts, q.captured)
        inj.clear()
        m.shutdown()
        return out

    plain, faulted = run(False), run(True)
    assert faulted[1] == 1 and plain[1] == 0 and faulted[2]
    assert faulted[0] == plain[0]
