"""The scheduler and the clock (``core/util/scheduler.py``,
``core/context.TimestampGenerator``) and TIMER chunks
(``QueryRuntime.process_timer``), held against the JAX package: the
playback heap fires in time order and dedupes, periodic jobs anchor at
the first event, ``clear_pending`` re-arms them, the ``@app:playback``
heartbeat drains a window with no trailing event, a live timer fires from
its own thread within a second, and a timer at ``pipeline_depth`` 4 drains
the in-flight batches of its query before its own chunk runs."""

import threading
import time

import numpy as np
import pytest
from torch_helpers import make_collector, make_query_collector


def _packages():
    import siddhi_tpu
    import siddhi_tpu_torch

    return {"jax": siddhi_tpu, "torch": siddhi_tpu_torch}


def _manager(pkg, config=None):
    pkgs = _packages()
    if pkg == "jax":
        from siddhi_tpu.core.util.config import InMemoryConfigManager

        m = pkgs["jax"].SiddhiManager()
    else:
        from siddhi_tpu_torch import InMemoryConfigManager

        m = pkgs["torch"].SiddhiManager(device="cpu")
    if config:
        m.set_config_manager(InMemoryConfigManager(dict(config)))
    return m


class _Ctx:
    """The two attributes a Scheduler reads from its app context."""

    def __init__(self, generator, playback=True):
        self.playback = playback
        self.timestamp_generator = generator
        generator.playback = playback


def _generator(pkg):
    if pkg == "jax":
        from siddhi_tpu.core.context import TimestampGenerator
    else:
        from siddhi_tpu_torch.core.context import TimestampGenerator
    return TimestampGenerator()


def _scheduler(pkg, ctx):
    if pkg == "jax":
        from siddhi_tpu.core.util.scheduler import Scheduler
    else:
        from siddhi_tpu_torch.core.util.scheduler import Scheduler
    return Scheduler(ctx)


def _script(pkg):
    """Timers requested out of order (one twice), periodic jobs, a
    clear_pending, and the clock moved in steps: the fired (ts, target)
    sequence."""
    gen = _generator(pkg)
    ctx = _Ctx(gen)
    sch = _scheduler(pkg, ctx)
    fired = []

    def target(name):
        return lambda ts: fired.append((name, ts))

    a, b = target("a"), target("b")
    sch.notify_at(300, a)
    sch.notify_at(100, b)
    sch.notify_at(200, a)
    sch.notify_at(100, b)                 # deduped
    job = sch.schedule_periodic(250, target("tick"))
    for ts in (50, 150, 150, 320, 900):
        gen.set_current_timestamp(ts)
    sch.notify_at(1000, a)
    sch.clear_pending()                   # drops 1000; re-arms the job at 900
    gen.set_current_timestamp(1400)
    sch.cancel(job)
    gen.set_current_timestamp(2000)
    sch.shutdown()
    sch.notify_at(2100, a)                # after shutdown: ignored
    gen.set_current_timestamp(2200)
    return fired


def test_playback_heap_order_dedupe_periodic_and_clear_pending():
    got, want = _script("torch"), _script("jax")
    assert got == want
    assert ("b", 100) in got and got.count(("b", 100)) == 1
    assert [ts for n, ts in got if n == "a"] == [200, 300]
    assert ("a", 1000) not in got


def test_time_change_listeners_and_once_first_time():
    gen = _generator("torch")
    gen.playback = True
    seen = []
    cancel = gen.once_first_time(lambda ts: seen.append(("first", ts)))
    gen.add_time_change_listener(lambda ts: seen.append(("every", ts)))
    gen.set_current_timestamp(5)
    gen.set_current_timestamp(3)          # backwards: no listener fires
    gen.set_current_timestamp(9)
    cancel()
    assert seen == [("first", 5), ("every", 5), ("every", 9)]
    assert gen.current_time() == 9


HEARTBEAT_APP = """
    @app:playback(idle.time = '300 millisecond', increment = '2 sec')
    define stream cseEventStream (symbol string, price float, volume int);
    @info(name = 'query1')
    from cseEventStream#window.time(2 sec)
    select symbol, price, volume insert all events into OutStream;
"""


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def test_playback_heartbeat_expires_rows_with_no_trailing_event():
    """PlaybackTestCase playbackTest8 on the port: the idle heartbeat
    advances the event clock by 2 sec and the time window drains both
    rows (idle.time 300 ms, as the reference's corpus scales it, so the
    sends are never split by a tick)."""
    from siddhi_tpu_torch import QueryCallback

    m = _manager("torch")
    rt = m.create_siddhi_app_runtime(HEARTBEAT_APP)
    q = make_query_collector(QueryCallback)
    rt.add_callback("query1", q)
    h = rt.get_input_handler("cseEventStream")
    ts = 1700000000000
    h.send(ts, ["IBM", 700.0, 0])
    h.send(ts, ["WSO2", 60.5, 1])
    assert _wait_for(lambda: sum(len(r) for _t, _i, r in q.calls) >= 2)
    m.shutdown()
    ins = [row for _t, i, _r in q.calls for row in i]
    removes = [row for _t, _i, r in q.calls for row in r]
    assert [d for _t, d, _e in ins] == [("IBM", 700.0, 0), ("WSO2", 60.5, 1)]
    assert [(t, d) for t, d, _e in removes] == [
        (ts + 2000, ("IBM", 700.0, 0)), (ts + 2000, ("WSO2", 60.5, 1))]


@pytest.mark.parametrize("idle, increment, error", [
    ("100 millisecond", "2", "SiddhiParserException"),
    ("", "2 sec", "SiddhiParserException"),
    ("100 millisecond", None, "SiddhiAppValidationException"),
])
def test_playback_annotation_is_parsed_strictly(idle, increment, error):
    from siddhi_tpu_torch.compiler import errors

    elems = f"idle.time = '{idle}'" + (
        f", increment = '{increment}'" if increment is not None else "")
    app = (f"@app:playback({elems}) define stream S (symbol string, price float, "
           f"volume int); from S#window.time(2 sec) select symbol "
           f"insert all events into OutStream;")
    with pytest.raises(getattr(errors, error)):
        _manager("torch").create_siddhi_app_runtime(app)


def test_live_timer_fires_from_its_thread_within_a_second():
    m = _manager("torch")
    rt = m.create_siddhi_app_runtime(
        "define stream S (symbol string, v long); @info(name = 'q') "
        "from S#window.time(200 millisec) select symbol, v "
        "insert expired events into O;")
    threads = []

    class Out(_packages()["torch"].StreamCallback):
        def __init__(self):
            super().__init__()
            self.rows = []

        def receive(self, events):
            threads.append(threading.get_ident())
            self.rows.extend((e.timestamp, tuple(e.data)) for e in events)

    c = Out()
    rt.add_callback("O", c)
    t0 = time.monotonic()
    rt.get_input_handler("S").send_columns(
        {"symbol": np.array(["A", "B", "C"], dtype=object),
         "v": np.array([1, 2, 3])})
    assert c.rows == []
    assert _wait_for(lambda: len(c.rows) == 3, timeout=2.0)
    waited = time.monotonic() - t0
    m.shutdown()
    assert 0.2 <= waited < 1.0, waited
    assert [d for _t, d in c.rows] == [("A", 1), ("B", 2), ("C", 3)]
    assert threading.get_ident() not in threads


PIPE_APP = """@app:playback
define stream S (sym string, v long);
@info(name = 'q')
from S#window.time(10 millisec)
select sym, sum(v) as total insert all events into Out;
"""


def _pipelined_timer_rows(pkg):
    """Three batches parked in flight at depth 4, then a timer at ts 100:
    its chunk expires every row, after the parked batches have emitted."""
    from siddhi_tpu_torch.core.event import HostBatch as THostBatch

    m = _manager(pkg, {"siddhi_tpu.pipeline_depth": "4"})
    rt = m.create_siddhi_app_runtime(PIPE_APP)
    c = make_collector(_packages()[pkg].StreamCallback)
    rt.add_callback("Out", c)
    qr = rt.query_runtimes["q"]
    pump = rt.app_context.completion_pump
    if pkg == "jax":
        from siddhi_tpu.core.event import HostBatch
    else:
        HostBatch = THostBatch
    defn = rt.junctions["S"].definition
    for i in range(3):
        rt.app_context.timestamp_generator.set_current_timestamp(i + 1)
        qr.receive_batch(HostBatch.from_columns(
            {"sym": np.array(["A", "B"], dtype=object), "v": np.array([i, 10 * i])},
            defn, rt.app_context.string_dictionary,
            timestamps=np.array([i + 1, i + 1], np.int64)))
    parked = pump.inflight(qr)
    qr.process_timer(100)
    assert pump.inflight(qr) == 0
    m.shutdown()
    return parked, c.rows


def test_timer_at_depth_four_drains_the_pump_first():
    parked, got = _pipelined_timer_rows("torch")
    _p, want = _pipelined_timer_rows("jax")
    assert parked == 3
    assert got == want
    # six rows of the three batches, then the timer chunk's six expired
    # rows (re-published as CURRENT), stamped at the timer's time
    assert [t for t, _d, _e in got] == [1, 1, 2, 2, 3, 3] + [100] * 6
    assert got[-1][1] == ("B", None)


def test_snapshot_limiter_delivers_empty_flushes_to_query_callbacks():
    """A snapshot rate limiter over an emptied window hands QueryCallbacks
    (None, None) flushes, as the reference does."""
    app = ("@app:playback define stream S (symbol string, v long); "
           "@info(name = 'q') from S#window.time(1 sec) select symbol, v "
           "output snapshot every 500 millisec insert all events into O;")
    calls = {}
    for pkg in ("jax", "torch"):
        m = _manager(pkg)
        rt = m.create_siddhi_app_runtime(app)
        qc = make_query_collector(_packages()[pkg].QueryCallback)
        rt.add_callback("q", qc)
        h = rt.get_input_handler("S")
        for ts, sym in ((1000, "A"), (1200, "B"), (3500, "C"), (5200, "D")):
            h.send(ts, [sym, ts])
        m.shutdown()
        calls[pkg] = qc.calls
    assert calls["torch"] == calls["jax"]
    assert any(not i and not r for _t, i, r in calls["torch"])


def _timer_steps(pkg):
    """Rows and TIMER steps of a playback time window over 40 events 10 ms
    apart (the runtime class's process_timer counted)."""
    from torch_helpers import Run

    if pkg == "jax":
        from siddhi_tpu.core.query.runtime import QueryRuntime
    else:
        from siddhi_tpu_torch.core.query.runtime import QueryRuntime
    n = [0]
    orig = QueryRuntime.process_timer

    def counted(self, ts):
        n[0] += 1
        return orig(self, ts)

    QueryRuntime.process_timer = counted
    try:
        r = Run(pkg, "@app:playback define stream S (symbol string, v long); "
                "@info(name='q') from S#window.time(100 millisec) select symbol, "
                "sum(v) as s group by symbol insert all events into O;", "O", "q")
        h = r.rt.get_input_handler("S")
        for i in range(40):
            h.send(1000 + i * 10, ["A", i])
        rows = r.close()
    finally:
        QueryRuntime.process_timer = orig
    return rows, n[0]


def test_timer_requests_are_deduped_with_the_reference_outputs():
    """The port hands the scheduler one stable timer target per query, so
    repeated requests for one time dedupe: one TIMER step per expiring
    millisecond. The reference passes a fresh bound method each time and
    runs a chain of timers per request (ROADMAP C, R3); the rows are the
    same."""
    got, steps = _timer_steps("torch")
    want, ref_steps = _timer_steps("jax")
    assert got == want
    assert steps == 30 < ref_steps
