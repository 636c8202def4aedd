"""Sources and sinks of the port (``core/stream/input/source.py``,
``core/stream/output/sink.py``, ``core/util/transport.py``), held against
the reference (tests/test_transport.py): inMemory source -> query ->
inMemory sink in both packages, passThrough and json mappers, a custom
source connecting with retry and backoff, a sink publish retried on
``ConnectionUnavailableException``, the roundRobin, broadcast and
partitioned distribution strategies, and a sink publishing exactly what a
StreamCallback on the same stream receives."""

import json
import time

import numpy as np
import pytest
from torch_helpers import make_collector

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.extension import (
    ConnectionUnavailableException, InMemoryBroker, Sink, Source)

PKGS = {"jax": siddhi_tpu, "torch": siddhi_tpu_torch}


def setup_function(_fn):
    InMemoryBroker.clear()
    from siddhi_tpu.core.util.transport import InMemoryBroker as RefBroker

    RefBroker.clear()


def _manager(pkg):
    return (siddhi_tpu.SiddhiManager() if pkg == "jax"
            else siddhi_tpu_torch.SiddhiManager(device="cpu"))


def _broker(pkg):
    if pkg == "jax":
        from siddhi_tpu.core.util.transport import InMemoryBroker as RefBroker

        return RefBroker
    return InMemoryBroker


def _listen(pkg, topic):
    got = []
    broker = _broker(pkg)

    class Sub(broker.Subscriber):
        def on_message(self, payload):
            got.append(payload)

    sub = Sub()
    sub.topic = topic
    broker.subscribe(sub)
    return got


ROUNDTRIP = """
@source(type='inMemory', topic='in')
define stream InStream (symbol string, price double);
@sink(type='inMemory', topic='out')
define stream OutStream (symbol string, price double);
from InStream[price > 10] select symbol, price insert into OutStream;
"""


@pytest.mark.parametrize("map_type", ["passThrough", "json"])
def test_inmemory_source_to_sink_like_the_reference(map_type):
    app = ROUNDTRIP
    if map_type == "json":
        app = app.replace("topic='in')", "topic='in', @map(type='json'))")
        app = app.replace("topic='out')", "topic='out', @map(type='json'))")
    payloads = [["WSO2", 55.5], ["IBM", 5.5], ["GOOG", 20.0]]
    if map_type == "json":
        payloads = [json.dumps({"event": {"symbol": s, "price": p}})
                    for s, p in payloads]
    out = {}
    for pkg in ("jax", "torch"):
        m = _manager(pkg)
        rt = m.create_siddhi_app_runtime(app)
        got = _listen(pkg, "out")
        rt.start()
        for p in payloads:
            _broker(pkg).publish("in", p)
        m.shutdown()
        out[pkg] = got
    assert out["torch"] == out["jax"]
    want = [["WSO2", 55.5], ["GOOG", 20.0]]
    if map_type == "json":
        want = [{"event": {"symbol": s, "price": p}} for s, p in want]
        assert [json.loads(p) for p in out["torch"]] == want
    else:
        assert out["torch"] == want


def test_sink_publishes_what_a_callback_receives():
    """The flagship's shape behind an inMemory source and sink at depth 4:
    the sink's payloads are the rows a StreamCallback on the same stream
    receives, in order."""
    m = _manager("torch")
    m.set_config_manager(siddhi_tpu_torch.InMemoryConfigManager(
        {"siddhi_tpu.pipeline_depth": "4"}))
    rt = m.create_siddhi_app_runtime("""
        @source(type='inMemory', topic='ticks')
        define stream StockStream (symbol string, price float, volume long);
        @sink(type='inMemory', topic='avgs')
        define stream OutStream (symbol string, avgPrice double, totalVolume long);
        @info(name = 'bench')
        from StockStream#window.length(10)
        select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
        group by symbol insert into OutStream;""")
    cb = make_collector(siddhi_tpu_torch.StreamCallback)
    rt.add_callback("OutStream", cb)
    got = _listen("torch", "avgs")
    rt.start()
    rng = np.random.default_rng(2)
    for i in range(40):
        InMemoryBroker.publish("ticks", [f"S{rng.integers(0, 5)}",
                                         float(rng.integers(1, 100)), int(i)])
    m.shutdown()
    assert len(got) == 40
    assert got == [list(d) for _t, d, _e in cb.rows]


def test_custom_source_with_retry_backoff():
    attempts = []

    class FlakySource(Source):
        def connect(self):
            attempts.append(time.monotonic())
            if len(attempts) < 3:
                raise ConnectionUnavailableException("down")
            self.handler(["OK", 1.0])

    m = _manager("torch")
    m.set_extension("source:flaky", FlakySource)
    rt = m.create_siddhi_app_runtime("""
        @source(type='flaky')
        define stream InStream (symbol string, price double);
        from InStream select symbol insert into OutStream;""")
    c = make_collector(siddhi_tpu_torch.StreamCallback)
    rt.add_callback("OutStream", c)
    rt.start()
    deadline = time.monotonic() + 10
    while not c.rows and time.monotonic() < deadline:
        time.sleep(0.02)
    m.shutdown()
    assert len(attempts) == 3           # two refusals, then a connection
    assert [d for _t, d, _e in c.rows] == [("OK",)]


def test_sink_publish_retries_until_the_transport_is_back():
    published = []

    class FlakySink(Sink):
        fails = 2

        def publish(self, payload):
            if FlakySink.fails:
                FlakySink.fails -= 1
                raise ConnectionUnavailableException("down")
            published.append(payload)

    m = _manager("torch")
    m.set_extension("sink:flaky", FlakySink)
    rt = m.create_siddhi_app_runtime("""
        define stream InStream (symbol string, price double);
        @sink(type='flaky')
        define stream OutStream (symbol string, price double);
        from InStream select symbol, price insert into OutStream;""")
    rt.get_input_handler("InStream").send(["A", 2.0])
    m.shutdown()
    assert published == [["A", 2.0]]


@pytest.mark.parametrize("strategy,extra,check", [
    ("roundRobin", "", lambda got: [len(got["d1"]), len(got["d2"])] == [2, 2]),
    ("broadcast", "", lambda got: got["d1"] == got["d2"] and len(got["d1"]) == 4),
    ("partitioned", ", partitionKey='symbol'",
     lambda got: sorted(map(tuple, got["d1"] + got["d2"])) == [
         ("S0", 0.0), ("S1", 1.0), ("S2", 2.0), ("S3", 3.0)]
     and not {p[0] for p in got["d1"]} & {p[0] for p in got["d2"]}),
])
def test_distribution_strategies(strategy, extra, check):
    m = _manager("torch")
    rt = m.create_siddhi_app_runtime(f"""
        @source(type='inMemory', topic='din')
        define stream InStream (symbol string, price double);
        @sink(type='inMemory', @distribution(strategy='{strategy}'{extra},
              @destination(topic='d1'), @destination(topic='d2')))
        define stream OutStream (symbol string, price double);
        from InStream select symbol, price insert into OutStream;""")
    got = {"d1": _listen("torch", "d1"), "d2": _listen("torch", "d2")}
    rt.start()
    for i in range(4):
        InMemoryBroker.publish("din", [f"S{i}", float(i)])
    m.shutdown()
    assert check(got), got
