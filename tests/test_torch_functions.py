"""The expression function library, extension functions, ``define
function`` scripts and query callbacks: the port against the JAX package.

The shapes of tests/test_function_corpus.py and the function shapes of
tests/test_filter_project.py whose windows are ported run through both
packages with the same sends; their outputs arrive through a
``QueryCallback`` in each package and must match under the tolerance rule
of ``torch_helpers`` (ints, strings, bools and sets exactly, floats to
rtol 1e-12). ``uuid()`` and ``currentTimeMillis()`` are compared by form:
distinct 36-character strings, and a value inside the send's wall-clock
window. Casts between strings and numbers run as host parse stages in the
reference's planner; the port names them as not ported."""

import time

import numpy as np
import pytest
import torch_helpers  # noqa: F401 — one torch thread per test process
from torch_helpers import assert_rows_match


def _package(pkg):
    if pkg == "jax":
        import siddhi_tpu as mod
        from siddhi_tpu.core.query.callback import QueryCallback
        from siddhi_tpu.extension import ScalarFunction

        return mod.SiddhiManager(), QueryCallback, ScalarFunction
    import siddhi_tpu_torch as mod
    from siddhi_tpu_torch.extension import ScalarFunction

    return mod.SiddhiManager(device="cpu"), mod.QueryCallback, ScalarFunction


def _callback(base):
    class QC(base):
        def __init__(self):
            self.calls = []

        def receive(self, timestamp, in_events, remove_events):
            self.calls.append((
                timestamp,
                None if in_events is None else [tuple(e.data) for e in in_events],
                None if remove_events is None else [tuple(e.data) for e in remove_events]))

    return QC()


def run(pkg, app, stream, sends, query="query1", extensions=()):
    """Send ``(ts, data)`` rows; returns the query callback's calls."""
    m, qc_base, scalar = _package(pkg)
    for name, make in extensions:
        m.set_extension(name, make(scalar))
    rt = m.create_siddhi_app_runtime(app)
    qc = _callback(qc_base)
    rt.add_callback(query, qc)
    h = rt.get_input_handler(stream)
    for ts, data in sends:
        h.send(ts, list(data))
    m.shutdown()
    return qc.calls


def rows_of(calls):
    """(timestamp, data, is_expired) rows, in delivery order."""
    out = []
    for ts, ins, rems in calls:
        out += [(ts, d, False) for d in ins or []]
        out += [(ts, d, True) for d in rems or []]
    return out


def both(app, stream, sends, **kw):
    want = run("jax", app, stream, sends, **kw)
    got = run("torch", app, stream, sends, **kw)
    assert [c[0] for c in got] == [c[0] for c in want]
    assert_rows_match(rows_of(got), rows_of(want))
    return got


CSE = ("define stream cseEventStream (symbol string, price1 float, "
       "price2 float, volume long, quantity int);")
TYPES = ("define stream typeStream (typeS string, typeF float, typeD double, "
         "typeI int, typeL long, typeB bool);")

CASES = {
    "coalesce_default": (
        CSE + "@info(name = 'query1') from cseEventStream select symbol, "
        "coalesce(price1, price2) as price, default(price1, 1.5f) as p1, "
        "default(quantity, 7) as q insert into StockQuote;",
        "cseEventStream",
        [["IBM", 55.6, 70.6, 1, 3], ["WSO2", 65.7, 12.8, 2, None],
         ["WSO2", 23.6, None, 3, 4], ["WSO2", None, 34.6, 4, None],
         ["WSO2", None, None, 5, 6]]),
    "coalesce_in_filter": (
        CSE + "@info(name = 'query1') from "
        "cseEventStream[coalesce(price1,price2) > 0f] select symbol, "
        "coalesce(price1,price2) as price,quantity insert into outputStream;",
        "cseEventStream",
        [["WSO2", 50.0, 60.0, 60, 6], ["WSO2", 70.0, None, 40, 10],
         ["WSO2", None, 44.0, 200, 56], ["WSO2", None, None, 200, 56]]),
    "if_then_else": (
        "define stream sensorEventStream (sensorValue double, status string);"
        "@info(name = 'query1') from sensorEventStream select sensorValue, "
        "ifThenElse(sensorValue>35,'High','Low') as status, "
        "ifThenElse(sensorValue>35, sensorValue, 0) as hi "
        "insert into outputStream;",
        "sensorEventStream", [[50.4, "x"], [20.4, "x"], [None, "y"]]),
    "filter_project_functions": (   # tests/test_filter_project.py shape
        "define stream S (v double);"
        "@info(name = 'query1') from S select "
        "ifThenElse(v > 0.0, 'pos', 'neg') as sign, maximum(v, 10.0) as mx, "
        "cast(v, 'int') as vi insert into Out;",
        "S", [[5.0], [-20.5], [12.25], [None]]),
    "maximum_minimum": (
        "define stream inputStream (price1 double, price2 double, "
        "price3 double, n int, m long);"
        "@info(name = 'query1') from inputStream select "
        "maximum(price1, price2, price3) as max, "
        "minimum(price1, price2, price3) as min, maximum(n, m) as mx, "
        "minimum(n, price1) as mn insert into outputStream;",
        "inputStream",
        [[36.0, 36.75, 35.75, 3, 9], [37.88, 38.12, 37.62, -4, -9],
         [39.00, None, 38.62, 1, 1], [38.12, 40.0, 37.75, 8, 2]]),
    "convert_numeric": (
        TYPES + "@info(name = 'query1') from typeStream select "
        "convert(typeF,'double') as a, convert(typeD,'int') as b, "
        "convert(typeI,'long') as c, convert(typeL,'float') as d, "
        "convert(typeF,'bool') as e, convert(typeD,'bool') as f, "
        "convert(typeI,'bool') as g, convert(typeL,'bool') as h, "
        "convert(typeB,'bool') as i, cast(typeD,'float') as j, "
        "cast(typeS,'string') as k, convert(typeB,'int') as l "
        "insert into outputStream;",
        "typeStream",
        [["WSO2", 2.0, 3.7, 4, 5, True], ["x", 1.0, 1.0, 1, 1, False],
         ["y", -2.5, -3.7, -4, None, True]]),
    "instance_of": (
        CSE + "@info(name = 'query1') from cseEventStream select "
        "instanceOfString(symbol) as a, instanceOfFloat(price1) as b, "
        "instanceOfDouble(price1) as c, instanceOfLong(volume) as d, "
        "instanceOfInteger(quantity) as e, instanceOfBoolean(symbol) as f "
        "insert into outputStream;",
        "cseEventStream", [["IBM", 1.5, 2.0, 1, 3], [None, None, 1.0, None, 2]]),
    "event_timestamp_and_log": (
        "define stream fooStream (symbol string, v int);"
        "@info(name = 'query1') from fooStream[log('row', v)] "
        "select symbol as name, eventTimestamp() as ts, v "
        "insert into barStream;",
        "fooStream", [["WSO2", 1], ["IBM", 2]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_library_agrees(case):
    app, stream, rows = CASES[case]
    got = both(app, stream, [(100 + i, r) for i, r in enumerate(rows)])
    assert got


def test_uuid_and_current_time_by_form():
    app = ("define stream S (symbol string);"
           "@info(name = 'query1') from S select symbol, uuid() as id, "
           "uuid() as id2, currentTimeMillis() as now insert into Out;")
    sends = [(10 + i, [s]) for i, s in enumerate("abcd")]
    for pkg in ("jax", "torch"):
        t0 = int(time.time() * 1000)
        rows = [r for _ts, r, _e in rows_of(run(pkg, app, "S", sends))]
        t1 = int(time.time() * 1000)
        ids = [r[1] for r in rows] + [r[2] for r in rows]
        assert [r[0] for r in rows] == list("abcd"), pkg
        assert len(set(ids)) == 8 and all(
            isinstance(i, str) and len(i) == 36 for i in ids), pkg
        assert all(t0 <= r[3] <= t1 for r in rows), pkg


def _plus(scalar):
    class Plus(scalar):
        @staticmethod
        def return_type(arg_types):
            return arg_types[0]

        @staticmethod
        def apply(xp, a, b):
            # numpy-named calls of the array namespace
            return xp.where(a > b, a, b) + xp.abs(b) - xp.minimum(a, b)

    return Plus


def test_extension_and_script_functions_agree():
    app = ("define function twice[python] return long { arg0 * 2 + arg1 };"
           "define stream cseEventStream (symbol string, price long, "
           "volume long);"
           "@info(name = 'query1') from cseEventStream select symbol, "
           "custom:plus(price, volume) as totalCount, twice(price, volume) as t "
           "insert into mailOutput;")
    sends = [(1, ["IBM", 700, 100]), (2, ["WSO2", 605, -200]), (3, ["ABC", 60, 200])]
    got = both(app, "cseEventStream", sends,
               extensions=[("function:custom:plus", _plus)])
    assert [r[1:] for _ts, r, _e in rows_of(got)] == [
        (700, 1500), (1005, 1010), (340, 320)]


@pytest.mark.parametrize("sel", [
    "coalesce() as x",
    "default(temp,0.0,deviceId) as x",
    "default(temp,123) as x",
    "eventTimestamp(time) as x",
    "convert(symbol) as x",
    "convert(symbol,'string','int') as x",
    "convert(symbol,'234') as x",
    "ifThenElse(temp>35,'High',5) as x",
    "ifThenElse(35,'High','Low') as x",
    "email:getAllNew(symbol,'') as x",
    "createSet(symbol, deviceId) as x",
    "sizeOfSet(roomNo) as x",
])
def test_invalid_calls_fail_in_both(sel):
    app = ("define stream cseEventStream (temp double, roomNo int, "
           "deviceId long, symbol string, time string);"
           f"@info(name = 'query1') from cseEventStream select {sel} "
           "insert into outputStream;")
    for pkg in ("jax", "torch"):
        m = _package(pkg)[0]
        with pytest.raises(Exception):
            m.create_siddhi_app_runtime(app)
        m.shutdown()


def test_string_number_cast_is_named_not_ported():
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.ops.expressions import CompileError

    m = SiddhiManager(device="cpu")
    for sel in ("convert(typeS, 'double')", "cast(typeI, 'string')"):
        with pytest.raises(CompileError, match="not ported"):
            m.create_siddhi_app_runtime(
                TYPES + f"from typeStream select {sel} as v insert into O;")


def test_query_callback_in_and_remove_split():
    # playback: an expired row's timestamp is the event clock, not wall time
    app = ("@app:playback define stream S (symbol string, v int);"
           "@info(name = 'query1') from S#window.length(2) "
           "select symbol, v insert all events into Out;")
    sends = [(i, [s, i]) for i, s in enumerate("abcde")]
    got = both(app, "S", sends)
    assert got[0][2] is None and got[-1][2] == [("c", 2)]


def test_removed_query_callback_stops_receiving():
    from siddhi_tpu_torch import QueryCallback, SiddhiManager

    m = SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(
        "define stream S (v int); @info(name = 'q') from S select v "
        "insert into Out;")
    qc = _callback(QueryCallback)
    rt.add_callback("q", qc)
    h = rt.get_input_handler("S")
    h.send([1])
    rt.remove_callback(qc)
    h.send([2])
    m.shutdown()
    assert [c[1] for c in qc.calls] == [[(1,)]]


def test_numpy_namespace_matches_torch_namespace():
    """The host namespace (keyers) offers the calls of the device one."""
    import torch

    from siddhi_tpu_torch.ops.expressions import NUMPY_XP, TorchXP

    txp = TorchXP("cpu")
    a = np.array([1.0, -4.0, 9.0])
    b = np.array([2.0, -5.0, 3.0])
    for name in ("maximum", "minimum", "fmod"):
        np.testing.assert_array_equal(
            getattr(txp, name)(torch.from_numpy(a), b).numpy(),
            getattr(NUMPY_XP, name)(a, b))
    np.testing.assert_array_equal(txp.where(a > 0, a, b).numpy(),
                                  NUMPY_XP.where(a > 0, a, b))
    np.testing.assert_array_equal(txp.sqrt(np.abs(a)).numpy(),
                                  NUMPY_XP.sqrt(np.abs(a)))
    assert int(txp.sum(a > 0, dtype=txp.int64)) == int(
        NUMPY_XP.sum(a > 0, dtype=NUMPY_XP.int64))
    assert txp.full((2,), 3, dtype=txp.float64).tolist() == [3.0, 3.0]
