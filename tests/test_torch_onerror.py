"""@OnError of the port against the reference, the scenarios of
tests/test_fault_stream_corpus.py (reference
``stream/FaultStreamTestCase.java``): errors are logged and the events
dropped by default and under ``action='log'``; under ``action='stream'``
the failing events reach the ``!S`` fault stream with an appended
``_error``, by a query or a direct callback; a capacity overflow still
raises to the sender. Each case runs in both packages."""

import numpy as np
import pytest
from torch_helpers import make_collector, release_jax_programs

import siddhi_tpu
import siddhi_tpu_torch

PKGS = {"jax": siddhi_tpu, "torch": siddhi_tpu_torch}


def _fault_fn(pkg):
    ext = __import__(f"{PKGS[pkg].__name__}.extension", fromlist=["ScalarFunction"])
    types = __import__(f"{PKGS[pkg].__name__}.query_api.definitions",
                       fromlist=["AttrType"])

    class FaultFn(ext.ScalarFunction):
        """The reference's FaultFunctionExtension: throws on every call."""

        return_type = types.AttrType.LONG

        @staticmethod
        def apply(xp, *args):
            raise RuntimeError("Error when running faultAdd()")

    return FaultFn


def _mk(pkg, app):
    mod = PKGS[pkg]
    m = mod.SiddhiManager() if pkg == "jax" else mod.SiddhiManager(device="cpu")
    m.set_extension("function:custom:fault", _fault_fn(pkg))
    return m, m.create_siddhi_app_runtime(app)


def _query_collector(pkg):
    class QCount(PKGS[pkg].QueryCallback):
        def __init__(self):
            self.events = []

        def receive(self, timestamp, in_events, remove_events):
            if in_events:
                self.events.extend(in_events)

    return QCount()


STREAM = ("define stream cseEventStream (symbol string, price float, "
          "volume long);")
FAULTY_QUERY = (
    "@info(name = 'query1') "
    "from cseEventStream[custom:fault() > volume] "
    "select symbol, price , symbol as sym1 "
    "insert into outputStream ;")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("annotation", ["", "@OnError(action='log')"])
def test_errors_are_logged_and_dropped(pkg, annotation, caplog):
    """faultStreamTest1/2: without @OnError, or with action='log', the
    error is logged, the event dropped, and send() does not raise."""
    m, rt = _mk(pkg, annotation + STREAM + FAULTY_QUERY)
    q = _query_collector(pkg)
    rt.add_callback("query1", q)
    rt.start()
    with caplog.at_level("ERROR"):
        rt.get_input_handler("cseEventStream").send(["IBM", 0.0, 100])
    m.shutdown()
    assert q.events == []
    assert any("error processing events" in r.message for r in caplog.records)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_onerror_stream_no_subscriber(pkg):
    """faultStreamTest3: nobody on the fault stream: the event vanishes
    quietly and nothing raises."""
    m, rt = _mk(pkg, "@OnError(action='stream')" + STREAM + FAULTY_QUERY)
    q = _query_collector(pkg)
    rt.add_callback("query1", q)
    rt.start()
    rt.get_input_handler("cseEventStream").send(["IBM", 0.0, 100])
    m.shutdown()
    assert q.events == []


def _fault_rows(pkg, via_query):
    app = "@OnError(action='stream')" + STREAM + FAULTY_QUERY
    if via_query:
        app += ("@info(name = 'query2') from !cseEventStream select * "
                "insert into faultStream;")
    m, rt = _mk(pkg, app)
    c = make_collector(PKGS[pkg].StreamCallback)
    rt.add_callback("faultStream" if via_query else "!cseEventStream", c)
    rt.start()
    h = rt.get_input_handler("cseEventStream")
    h.send(1, ["IBM", 0.0, 100])
    h.send_columns({"symbol": np.array(["A", "B"], dtype=object),
                    "price": np.array([1.5, 2.5], np.float32),
                    "volume": np.array([1, 2], np.int64)},
                   timestamps=np.array([5, 6], np.int64))
    m.shutdown()
    return c.rows


@pytest.mark.parametrize("via_query", [True, False])
def test_fault_stream_carries_the_failing_events(via_query):
    """faultStreamTest4/5: a `from !cseEventStream` query, or a callback on
    '!cseEventStream', sees each failing event with its attributes and
    the error text in `_error`, in both packages alike."""
    got, want = _fault_rows("torch", via_query), _fault_rows("jax", via_query)
    assert [(t, d[:3], e) for t, d, e in got] == [(t, d[:3], e) for t, d, e in want]
    assert [d[:3] for _t, d, _e in got] == [("IBM", 0.0, 100), ("A", 1.5, 1),
                                            ("B", 2.5, 2)]
    assert all("faultAdd" in d[3] for _t, d, _e in got)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_capacity_overflow_still_raises(pkg):
    """Framework failures (dense capacity knobs) keep propagating to the
    sender, also under @OnError(action='stream')."""
    mod = PKGS[pkg]
    m = mod.SiddhiManager() if pkg == "jax" else mod.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(
        "@OnError(action='stream') define stream S (v long);"
        "@info(name = 'q') from S#window.length(100) "
        "select distinctCount(v) as n insert into O;")
    for spec in rt.query_runtimes["q"].selector_plan.specs:
        spec.distinct_capacity = 4
    rt.start()
    h = rt.get_input_handler("S")
    with pytest.raises(RuntimeError, match="distinct_values_capacity"):
        for i in range(10):
            h.send([i])
    m.shutdown()
