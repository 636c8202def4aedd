"""Partitions in the port against the JAX package, app by app on the same
sends (stream rows, ints exact, floats to rtol 1e-12, the rule of
``tests/torch_helpers.py``): the refusals, the shapes of
``tests/test_partitions.py`` (range, inner stream, time), every case of
``tests/test_window_partition_corpus.py`` and
``tests/test_partitioned_host_windows.py``, the keyed cases of
``tests/test_keyed_windows_new.py`` (its join case waits for joins), and
``@purge`` (``tests/test_partition_purge.py``), also under ``output last
every 2 events``."""

import time

import numpy as np
import pytest
from torch_helpers import PLAYBACK_STOCK, assert_rows_match, make_collector

P = "partition with (symbol of S) begin @info(name='q') "


def test_partition_refusals_match_reference():
    """What the reference refuses inside a partition, the port refuses with
    the same text; a global stream with no partition clause too."""
    from siddhi_tpu import SiddhiManager as JM
    from siddhi_tpu_torch import SiddhiManager as TM

    for app in (
            P + "from S#window.lengthBatch(3, true) select symbol insert into O; end;",
            P + "from S#window.timeBatch(1 sec, 0) select symbol insert into O; end;",
            P + "from S#window.batch(3) select symbol insert into O; end;",
            "define stream T (x int); " + P + "from T select x insert into O; end;",
            "partition with (symbol of S) begin from #Nope select symbol insert "
            "into O; end;"):
        errs = []
        for m in (JM(), TM(device="cpu")):
            try:
                m.create_siddhi_app_runtime(PLAYBACK_STOCK + app)
                errs.append(None)
            except Exception as e:            # noqa: BLE001 — compared below
                errs.append(str(e))
            m.shutdown()
        assert errs[0] is not None and errs[0] == errs[1], errs


# ------------------------------------------------- the reference test shapes

def _run_rows(pkg, app, sends, out):
    """Events of ``sends`` [(stream, ts, row), ...] through one package;
    the output stream's (ts, data, expired) rows."""
    if pkg == "jax":
        import siddhi_tpu as mod
        m = mod.SiddhiManager()
    else:
        import siddhi_tpu_torch as mod
        m = mod.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(app)
    cols = {o: make_collector(mod.StreamCallback) for o in out}
    for o, c in cols.items():
        rt.add_callback(o, c)
    for sid, ts, row in sends:
        rt.get_input_handler(sid).send(ts, row)
    m.shutdown()
    return {o: c.rows for o, c in cols.items()}


def _both(app, sends, out=("OutStream",)):
    # playback: the clock (and so expired rows' stamps) follows the sends
    if "@app:playback" not in app:
        app = "@app:playback " + app
    got, want = _run_rows("torch", app, sends, out), _run_rows("jax", app, sends, out)
    for o in out:
        assert_rows_match(got[o], want[o])
        assert want[o], o
    return got


def _seq(stream, rows, t0=1000, dt=10):
    return [(stream, t0 + i * dt, r) for i, r in enumerate(rows)]


CSE = "define stream cseEventStream (symbol string, price float, volume int);\n"
CSE_ROWS = [["IBM", 70.0, 100], ["WSO2", 700.0, 100], ["IBM", 100.0, 100],
            ["IBM", 200.0, 100], ["ORACLE", 75.6, 100], ["WSO2", 1000.0, 100],
            ["WSO2", 500.0, 100]]

SHAPES = {
    # tests/test_partitions.py
    "range_partition": (
        "define stream StockStream (symbol string, price float);\n"
        "partition with (price < 100 as 'cheap' or price >= 100 as 'pricey' of "
        "StockStream) begin from StockStream select symbol, count() as cnt insert "
        "into OutStream; end;",
        _seq("StockStream", [["A", 50.0], ["B", 150.0], ["C", 60.0]]), ("OutStream",)),
    "inner_stream_carries_partition": (
        "define stream StockStream (symbol string, price float);\n"
        "partition with (symbol of StockStream) begin from StockStream select "
        "symbol, price * 2 as doubled insert into #Mid; from #Mid select symbol, "
        "sum(doubled) as total insert into OutStream; end;",
        _seq("StockStream", [["A", 1.0], ["B", 10.0], ["A", 2.0]]), ("OutStream",)),
    "partitioned_time_window": (
        "@app:playback define stream S (symbol string, v int);\n"
        "partition with (symbol of S) begin from S#window.time(100) select symbol, "
        "sum(v) as total insert into OutStream; end;",
        [("S", 1000, ["A", 1]), ("S", 1010, ["B", 10]), ("S", 1050, ["A", 2]),
         ("S", 1200, ["A", 4]), ("S", 1210, ["B", 40])], ("OutStream",)),
    # tests/test_window_partition_corpus.py
    "corpus_q1_length_expired": (
        CSE + "partition with (symbol of cseEventStream) begin @info(name = 'query1') "
        "from cseEventStream#window.length(2) select symbol, sum(price) as price, "
        "volume insert expired events into OutStockStream; end;",
        _seq("cseEventStream", CSE_ROWS), ("OutStockStream",)),
    "corpus_q2_length_batch_all": (
        CSE + "partition with (symbol of cseEventStream) begin @info(name = 'query1') "
        "from cseEventStream#window.lengthBatch(2) select symbol, sum(price) as "
        "price, volume insert all events into OutStockStream; end;",
        _seq("cseEventStream", CSE_ROWS[:4] + CSE_ROWS[5:6]), ("OutStockStream",)),
    "corpus_q3_time_default_sum": (
        "@app:playback " + CSE + "define stream Tick (x int);\n"
        "partition with (symbol of cseEventStream) begin @info(name = 'query1') "
        "from cseEventStream#window.time(1 sec) select symbol, default(sum(price), "
        "0.0) as price, volume insert all events into OutStockStream; end; "
        "from Tick select x insert into TickOut;",
        [("cseEventStream", 1000, ["IBM", 70.0, 100]),
         ("cseEventStream", 1100, ["WSO2", 700.0, 100]),
         ("cseEventStream", 1200, ["IBM", 100.0, 200]), ("Tick", 4200, [0]),
         ("cseEventStream", 4300, ["IBM", 200.0, 300]),
         ("cseEventStream", 4400, ["WSO2", 1000.0, 100]), ("Tick", 6500, [0])],
        ("OutStockStream",)),
    "corpus_q4_length_current": (
        CSE + "partition with (symbol of cseEventStream) begin @info(name = 'query1') "
        "from cseEventStream#window.length(2) select symbol, sum(price) as price, "
        "volume insert into OutStockStream; end;",
        _seq("cseEventStream", CSE_ROWS), ("OutStockStream",)),
    "corpus_q5_time_batch": (
        "@app:playback define stream cseEventStream (symbol string, price double, "
        "volume int); define stream Tick (x int);\n"
        "partition with (symbol of cseEventStream) begin @info(name = 'query1') "
        "from cseEventStream#window.timeBatch(5 sec) select symbol, sum(price) as "
        "price, volume insert into OutStockStream; end; "
        "from Tick select x insert into TickOut;",
        [("cseEventStream", 1000, r) for r in CSE_ROWS] + [("Tick", 7000, [0])],
        ("OutStockStream",)),
    "corpus_q6_length_batch_chained": (
        "define stream SensorStream (id string, sensorValue double);\n"
        "partition with (id of SensorStream) begin @info(name = 'query1') from "
        "SensorStream#window.lengthBatch(2) select id, sensorValue insert events "
        "into OutputStream; @info(name = 'query2') from OutputStream select * "
        "insert into TempStream; end;",
        _seq("SensorStream", [["id1", 111.0], ["id1", 112.0], ["id2", 121.0],
                              ["id2", 122.0], ["id3", 131.0], ["id3", 132.0]]),
        ("OutputStream", "TempStream")),
    # tests/test_partitioned_host_windows.py
    "host_sort": (
        "define stream S (sym string, price double);\n"
        "partition with (sym of S) begin from S#window.sort(2, price) select sym, "
        "sum(price) as total insert into OutStream; end;",
        _seq("S", [["A", 50.0], ["A", 20.0], ["A", 40.0], ["B", 5.0]]), ("OutStream",)),
    "host_frequent": (
        "define stream S (sym string, item string);\n"
        "partition with (sym of S) begin from S#window.frequent(1, item) select "
        "sym, item insert into OutStream; end;",
        _seq("S", [["A", "x"], ["A", "x"], ["A", "y"], ["B", "z"]]), ("OutStream",)),
    "host_expression_batch": (
        "define stream S (sym string, v int);\n"
        "partition with (sym of S) begin from S#window.expressionBatch('count() <= "
        "2') select sym, sum(v) as total insert into OutStream; end;",
        _seq("S", [["A", 1], ["A", 2], ["A", 3], ["B", 9]]), ("OutStream",)),
    # tests/test_keyed_windows_new.py (keyed cases; the join waits for joins)
    "keyed_external_time_sum": (
        "@app:playback define stream S (sym string, ets long, v int);\n"
        "partition with (sym of S) begin from S#window.externalTime(ets, 1 sec) "
        "select sym, sum(v) as total insert into OutStream; end;",
        [("S", 1000, ["A", 1000, 10]), ("S", 1200, ["B", 1200, 100]),
         ("S", 1500, ["A", 1500, 20]), ("S", 2300, ["A", 2300, 30]),
         ("S", 5000, ["B", 5000, 1])], ("OutStream",)),
    "keyed_external_time_keeps_ts": (
        "@app:playback define stream S (sym string, ets long, v int);\n"
        "partition with (sym of S) begin from S#window.externalTime(ets, 1 sec) "
        "select sym, v insert all events into OutStream; end;",
        [("S", 1000, ["A", 1000, 1]), ("S", 2500, ["A", 2500, 2])], ("OutStream",)),
    "keyed_time_length_count_cap": (
        "@app:playback define stream S (sym string, v int);\n"
        "partition with (sym of S) begin from S#window.timeLength(10 sec, 2) "
        "select sym, sum(v) as total insert into OutStream; end;",
        [("S", 1000, ["A", 1]), ("S", 1100, ["A", 2]), ("S", 1200, ["A", 4]),
         ("S", 1300, ["B", 100]), ("S", 1400, ["A", 8])], ("OutStream",)),
    "keyed_time_length_time": (
        "@app:playback define stream S (sym string, v int);\n"
        "partition with (sym of S) begin from S#window.timeLength(1 sec, 10) "
        "select sym, sum(v) as total insert into OutStream; end;",
        [("S", 1000, ["A", 5]), ("S", 2500, ["A", 7])], ("OutStream",)),
    "keyed_hopping_phase": (
        "@app:playback define stream S (sym string, v int);\n"
        "partition with (sym of S) begin from S#window.hopping(3 sec, 1 sec) "
        "select sym, sum(v) as total insert into OutStream; end;",
        [("S", 1000, ["A", 1]), ("S", 1500, ["B", 10]), ("S", 2100, ["A", 2]),
         ("S", 2600, ["B", 20]), ("S", 3100, ["A", 4])], ("OutStream",)),
    "keyed_delay": (
        "@app:playback define stream S (sym string, v int);\n"
        "partition with (sym of S) begin from S#window.delay(1 sec) select sym, v "
        "insert into OutStream; end;",
        [("S", 1000, ["A", 1]), ("S", 1100, ["B", 2]), ("S", 2200, ["A", 3])],
        ("OutStream",)),
    "keyed_session_latency": (
        "@app:playback define stream S (sym string, v int);\n"
        "partition with (sym of S) begin from S#window.session(2 sec, sym, 1 sec) "
        "select sym, v insert all events into OutStream; end;",
        [("S", 1000, ["u1", 1]), ("S", 3500, ["u2", 9]), ("S", 3700, ["u1", 2]),
         ("S", 9000, ["u2", 0])], ("OutStream",)),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_reference_partition_shapes_match(name):
    app, sends, out = SHAPES[name]
    _both(app, sends, out)


def test_keyed_chunks_match_reference():
    """Multi-row chunks (one send of a column batch): the keyed batch
    window replaces each key's batch per chunk, a lengthBatch chunk
    flushes every key, and a backwards externalTime clock inside a chunk
    never expires early (tests/test_keyed_windows_new.py)."""
    from torch_helpers import Run

    cases = [
        ("@app:playback define stream S (sym string, v int);\npartition with (sym of "
         "S) begin @info(name='q') from S#window.batch() select sym, sum(v) as total "
         "insert into OutStream; end;",
         [("cols", {"sym": np.array(["A", "A", "B"], dtype=object),
                    "v": np.array([1, 2, 10])}, np.array([1000, 1000, 1000])),
          ("event", 1100, ["A", 5])]),
        ("@app:playback define stream S (sym string, v int);\npartition with (sym of "
         "S) begin @info(name='q') from S#window.lengthBatch(2) select sym, sum(v) as "
         "total insert into OutStream; end;",
         [("cols", {"sym": np.array(["A", "A", "B", "B"], dtype=object),
                    "v": np.array([1, 2, 10, 20])}, np.array([1000] * 4))]),
        ("@app:playback define stream S (sym string, ets long, v int);\npartition "
         "with (sym of S) begin @info(name='q') from S#window.externalTime(ets, 1 "
         "sec) select sym, sum(v) as total insert into OutStream; end;",
         [("cols", {"sym": np.array(["A", "A", "B", "A"], dtype=object),
                    "ets": np.array([2000, 1500, 9000, 3500]),
                    "v": np.array([1, 2, 100, 4])},
           np.array([2000, 2100, 2200, 2300]))]),
    ]
    for app, feed in cases:
        rows = [Run(pkg, app, "OutStream", "q").feed("S", feed).close()
                for pkg in ("torch", "jax")]
        assert rows[1]
        assert_rows_match(rows[0], rows[1])


# ----------------------------------------------------------------- @purge

PURGE_APP = """
    define stream S (k string, v int);
    @purge(enable='true', interval='10 sec', idle.period='1 hour')
    partition with (k of S)
    begin
      @info(name='q')
      from S#window.length(4) select k, sum(v) as s {rate} insert into OutStream;
    end;
"""


def _purge_run(pkg, rate=""):
    """tests/test_partition_purge.py:18-51 through one package: p1 goes
    idle, is purged, and a new key p3 takes its id."""
    if pkg == "jax":
        import siddhi_tpu as mod
        m = mod.SiddhiManager()
    else:
        import siddhi_tpu_torch as mod
        m = mod.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(PURGE_APP.format(rate=rate))
    c = make_collector(mod.StreamCallback)
    rt.add_callback("OutStream", c)
    h = rt.get_input_handler("S")
    sends = [["p1", 10], ["p1", 20], ["p2", 5], ["p1", 1]]
    for i, row in enumerate(sends):
        h.send(1000 + i, row)
    pctx = rt.partition_contexts[0]
    assert pctx.purge_interval_ms == 10_000 and pctx.purge_idle_ms == 3600_000
    ks = pctx.keyspace
    p1_id = ks._map[(rt.app_context.string_dictionary.encode("p1"),)]
    ks.last_seen[p1_id] = int(time.time() * 1000) - 2 * 3600_000
    freed = pctx.purge()
    for i, row in enumerate([["p3", 7], ["p2", 6], ["p3", 8], ["p3", 9]]):
        h.send(2000 + i, row)
    p3_id = ks._map[(rt.app_context.string_dictionary.encode("p3"),)]
    m.shutdown()
    return freed, p1_id, p3_id, c.rows


@pytest.mark.parametrize("rate", ["", "output last every 2 events"])
def test_purge_recycles_ids_with_clean_state(rate):
    got, want = _purge_run("torch", rate), _purge_run("jax", rate)
    freed, p1_id, p3_id, rows = got
    assert freed == [p1_id] and p3_id == p1_id == want[1]
    assert_rows_match(rows, want[3])
    # the recycled id starts clean: p3's first sum is its own value
    p3 = [d for _t, d, _e in rows if d[0] == "p3"]
    if not rate:
        assert p3[0] == ("p3", 7)


def test_purge_job_runs_on_the_scheduler():
    """The periodic purge job is armed at start: in playback its ticks
    follow event time, and it retires a key idle past the wall-clock
    period (idle.period of 1 ms)."""
    import siddhi_tpu_torch as tp

    m = tp.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(
        "@app:playback define stream S (k string, v int);\n"
        "@purge(enable='true', interval='1 sec', idle.period='1 ms')\n"
        "partition with (k of S) begin @info(name='q') from S#window.time(10 sec) "
        "select k, sum(v) as s insert into OutStream; end;")
    c = make_collector(tp.StreamCallback)
    rt.add_callback("OutStream", c)
    h = rt.get_input_handler("S")
    h.send(1000, ["a", 1])
    time.sleep(0.01)
    h.send(3000, ["b", 2])      # the purge tick at 2000 retires 'a'
    ks = rt.partition_contexts[0].keyspace
    assert len(ks._free) == 1 or ks._map.get(
        (rt.app_context.string_dictionary.encode("b"),)) == 0
    h.send(3001, ["c", 3])
    m.shutdown()
    assert [d for _t, d, _e in c.rows] == [("a", 1), ("b", 2), ("c", 3)]
