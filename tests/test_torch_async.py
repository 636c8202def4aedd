"""@Async junctions of the port (``core/stream/junction.py``), held against
the reference (tests/test_async_junction.py): re-batching with
``max.delay``, the ``latency.target`` adaptive batch cap, a framework
failure on the worker re-raised on every later send, and a replacement
worker that takes over without delivering anything twice."""

import threading
import time

import numpy as np
import pytest
import torch
from torch_helpers import assert_rows_match, make_collector

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.core.context import SiddhiAppContext, SiddhiContext
from siddhi_tpu_torch.core.event import Event
from siddhi_tpu_torch.core.stream.junction import FatalQueryError, Receiver, StreamJunction
from siddhi_tpu_torch.query_api.definitions import Attribute, AttrType, StreamDefinition


def _wait_for(predicate, timeout=10.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def _manager(pkg):
    if pkg == "jax":
        return siddhi_tpu.SiddhiManager()
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


ASYNC_APP = """
@Async(buffer.size='256', batch.size='64', max.delay='5 ms')
define stream S (sym string, v long);
@info(name = 'q')
from S#window.length(6) select sym, sum(v) as s, count() as c group by sym
insert into Out;
"""


def _async_rows(pkg):
    m = _manager(pkg)
    rt = m.create_siddhi_app_runtime(ASYNC_APP)
    c = make_collector((siddhi_tpu if pkg == "jax" else siddhi_tpu_torch).StreamCallback)
    rt.add_callback("Out", c)
    h = rt.get_input_handler("S")
    for i in range(40):          # trickle: one event per send
        h.send(i, [f"K{i % 4}", i])
    h.send_columns({"sym": np.array([f"K{i % 3}" for i in range(30)], dtype=object),
                    "v": np.arange(30, dtype=np.int64)},
                   timestamps=np.arange(40, 70, dtype=np.int64))
    assert _wait_for(lambda: len(c.rows) == 70), len(c.rows)
    m.shutdown()
    return c.rows


def test_async_app_delivers_all_events_in_order_like_the_reference():
    got = _async_rows("torch")
    assert [t for t, _d, _e in got] == list(range(70))    # order kept
    assert_rows_match(got, _async_rows("jax"))


def _mk_junction():
    ctx = SiddhiAppContext(SiddhiContext(device=torch.device("cpu")), "t")
    sdef = StreamDefinition(id="S", attributes=[Attribute("v", AttrType.LONG)])
    return StreamJunction(sdef, ctx)


class _SlowReceiver(Receiver):
    def __init__(self, sleep_s):
        self.sleep_s = sleep_s
        self.batches = []
        self.values = []

    def receive(self, events):
        time.sleep(self.sleep_s)
        self.batches.append(len(events))
        self.values.extend(e.data[0] for e in events)


def test_latency_target_shrinks_then_regrows_batch_cap():
    j = _mk_junction()
    j.enable_async(buffer_size=4096, batch_size=256, latency_target_ms=5.0)
    slow = _SlowReceiver(0.02)   # 20 ms per delivery >> 5 ms target
    j.subscribe(slow)
    j.start_processing()
    for i in range(600):
        j.send_events([Event(timestamp=i, data=[i])])
    assert _wait_for(lambda: sum(slow.batches) == 600), sum(slow.batches)
    assert j._cur_batch < 256, j._cur_batch
    shrunk = j._cur_batch
    slow.sleep_s = 0.0           # headroom regrows the cap
    for i in range(600):
        j.send_events([Event(timestamp=i, data=[i])])
    assert _wait_for(lambda: sum(slow.batches) == 1200), sum(slow.batches)
    assert j._cur_batch > shrunk, (j._cur_batch, shrunk)
    j.stop_processing()


def test_max_delay_coalesces_trickled_events():
    j = _mk_junction()
    j.enable_async(buffer_size=4096, batch_size=1024, max_delay_ms=50.0)
    rec = _SlowReceiver(0.0)
    j.subscribe(rec)
    j.start_processing()
    for i in range(20):
        j.send_events([Event(timestamp=i, data=[i])])
        time.sleep(0.002)
    assert _wait_for(lambda: sum(rec.batches) == 20), sum(rec.batches)
    assert len(rec.batches) <= 5, rec.batches
    assert rec.values == list(range(20))
    j.stop_processing()


def test_fatal_error_on_the_worker_reraises_on_later_sends():
    """A distinct value table overflowing on the @Async worker stops it
    and stores the error: every later send raises it, naming the knob."""
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime("""
        @Async(buffer.size='8')
        define stream S (v long);
        @info(name = 'q') from S#window.length(100)
        select distinctCount(v) as n insert into O;""")
    for spec in rt.query_runtimes["q"].selector_plan.specs:
        spec.distinct_capacity = 4
    h = rt.get_input_handler("S")
    j = rt.junctions["S"]
    h.send_columns({"v": np.arange(10, dtype=np.int64)})
    assert _wait_for(lambda: j._fatal is not None)
    for _ in range(2):
        with pytest.raises(FatalQueryError, match="distinct_values_capacity"):
            h.send([1])
    m.shutdown()


class _Gate(Receiver):
    """Blocks the first delivery until released; records every value."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.values = []

    def receive(self, events):
        if not self.entered.is_set():
            self.entered.set()
            assert self.release.wait(10.0)
        self.values.extend(e.data[0] for e in events)


def test_restart_worker_takes_over_without_double_delivery():
    """A wedged worker is replaced: the replacement waits while the old
    one still delivers its unit, and the old one retires after it; every
    event arrives once, in order."""
    j = _mk_junction()
    j.enable_async(buffer_size=64, batch_size=1)
    gate = _Gate()
    j.subscribe(gate)
    j.start_processing()
    j.send_events([Event(timestamp=0, data=[0])])
    assert gate.entered.wait(10.0)           # worker 1 is wedged in delivery
    for i in range(1, 6):
        j.send_events([Event(timestamp=i, data=[i])])
    old = j._worker
    j.restart_worker()
    assert j._worker is not old
    gate.release.set()
    assert _wait_for(lambda: len(gate.values) == 6), gate.values
    assert gate.values == list(range(6))
    old.join(5.0)
    assert not old.is_alive()
    j.stop_processing()
