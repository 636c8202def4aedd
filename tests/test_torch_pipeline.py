"""The dispatch pipeline (``core/query/completion.py``, CompletionPump) of
the port, held against the reference's (tests/test_pipeline.py): per-query
dispatch-order emission with depth-bounded in-flight batches, synchronous
sends that still observe their outputs at once, overflow surfacing as
``FatalQueryError`` on the producer's next interaction with its knob
named, an @Async worker's idle flush, a drain-time error routed to the
fault stream with its input events, depth 1 bypassing the pump, and the
same feed giving the same rows at depths 1, 4 and 8 in both packages.

Direct ``receive_batch`` calls park batches in the pipeline: junction
sends flush the pump before returning."""

import time

import numpy as np
import pytest
from torch_helpers import assert_rows_match, make_collector, stock_feed

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.core.event import HostBatch

PKGS = {"jax": siddhi_tpu, "torch": siddhi_tpu_torch}

APP = """
define stream S (sym string, v long);
@info(name='pq')
from S#window.length(8)
  select sym, sum(v) as total group by sym
  insert into Out;
"""


def _manager(pkg, depth):
    from siddhi_tpu.core.util.config import InMemoryConfigManager as RefConfig

    cfg = {"siddhi_tpu.pipeline_depth": str(depth)}
    if pkg == "jax":
        m = siddhi_tpu.SiddhiManager()
        m.set_config_manager(RefConfig(cfg))
    else:
        m = siddhi_tpu_torch.SiddhiManager(device="cpu")
        m.set_config_manager(siddhi_tpu_torch.InMemoryConfigManager(cfg))
    return m


def _collector(pkg):
    return make_collector(PKGS[pkg].StreamCallback)


def _rows(c):
    return [d for _t, d, _e in c.rows]


def _batch(rt, vals, ts0=0):
    defn = rt.junctions["S"].definition
    n = len(vals)
    return HostBatch.from_columns(
        {"sym": np.array(["A"] * n, dtype=object), "v": np.asarray(vals, np.int64)},
        defn, rt.app_context.string_dictionary,
        timestamps=np.arange(ts0, ts0 + n, dtype=np.int64))


def _wait_for(pred, timeout=10.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.005)
    return False


def test_sync_sends_keep_synchronous_semantics():
    m = _manager("torch", 4)
    rt = m.create_siddhi_app_runtime(APP)
    out = _collector("torch")
    rt.add_callback("Out", out)
    h = rt.get_input_handler("S")
    h.send(["A", 1])
    assert _rows(out) == [("A", 1)]
    h.send(["A", 2])
    assert _rows(out) == [("A", 1), ("A", 3)]
    assert not rt.app_context.completion_pump.has_pending
    m.shutdown()


def test_inflight_batches_emit_in_dispatch_order():
    m = _manager("torch", 4)
    rt = m.create_siddhi_app_runtime(APP)
    out = _collector("torch")
    rt.add_callback("Out", out)
    qr = rt.query_runtimes["pq"]
    pump = rt.app_context.completion_pump
    for i in range(3):
        qr.receive_batch(_batch(rt, [i + 1], ts0=i))
    assert pump.inflight(qr) == 3 and out.rows == []
    pump.flush()
    assert pump.inflight(qr) == 0
    assert _rows(out) == [("A", 1), ("A", 3), ("A", 6)]
    assert pump.high_water == 3
    m.shutdown()


def test_depth_bound_forces_batched_drain():
    m = _manager("torch", 2)
    rt = m.create_siddhi_app_runtime(APP)
    out = _collector("torch")
    rt.add_callback("Out", out)
    qr = rt.query_runtimes["pq"]
    pump = rt.app_context.completion_pump
    for i in range(5):
        qr.receive_batch(_batch(rt, [1], ts0=i))
        assert pump.inflight(qr) <= 2
    assert _rows(out) == [("A", k) for k in range(1, len(out.rows) + 1)]
    pump.flush()
    assert _rows(out) == [("A", k) for k in range(1, 6)]
    assert pump.pulls >= 2 and pump.metas == 5
    m.shutdown()


OVERFLOW_APP = """
define stream S (v long);
@info(name = 'q') from S#window.length(100)
select distinctCount(v) as n insert into Out;
"""


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_overflow_reaches_producer_as_fatal_with_knob_named(pkg):
    """An overflow riding a pipelined meta surfaces on the producer's next
    interaction, naming the capacity knob, and the overflowed batch does
    not emit; the earlier batch of the round still does."""
    m = _manager(pkg, 4)
    rt = m.create_siddhi_app_runtime(OVERFLOW_APP)
    out = _collector(pkg)
    rt.add_callback("Out", out)
    qr = rt.query_runtimes["q"]
    for spec in qr.selector_plan.specs:
        spec.distinct_capacity = 4
    defn = rt.junctions["S"].definition
    batch = PKGS[pkg].core.event.HostBatch
    dic = rt.app_context.string_dictionary
    qr.receive_batch(batch.from_columns({"v": np.array([1, 2], np.int64)}, defn, dic,
                                        timestamps=np.arange(2, dtype=np.int64)))
    qr.receive_batch(batch.from_columns({"v": np.arange(10, 20, dtype=np.int64)},
                                        defn, dic, timestamps=np.arange(2, 12, dtype=np.int64)))
    pump = rt.app_context.completion_pump
    assert pump.inflight(qr) == 2
    with pytest.raises(RuntimeError, match=r"q.*distinct_values_capacity"):
        pump.flush()
    assert _rows(out) == [(1,), (2,)]
    m.shutdown()


def test_async_idle_flush_bounds_trickle_lag():
    m = _manager("torch", 8)
    rt = m.create_siddhi_app_runtime("@Async(buffer.size='64')" + APP)
    out = _collector("torch")
    rt.add_callback("Out", out)
    rt.start()
    rt.get_input_handler("S").send(["A", 5])
    assert _wait_for(lambda: out.rows)
    assert _rows(out) == [("A", 5)]
    m.shutdown()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_drain_error_routes_to_fault_stream_with_events(pkg):
    """A non-fatal error escaping ``_emit`` at drain (a raising
    QueryCallback) reaches the @OnError(action='stream') fault junction
    WITH the failing input events, as on the synchronous path."""
    mod = PKGS[pkg]
    m = _manager(pkg, 4)
    rt = m.create_siddhi_app_runtime("""
        @OnError(action='stream')
        define stream S (sym string, v long);
        @info(name='pq') from S select sym, v insert into Out;
    """)

    class Boom(mod.QueryCallback):
        def receive(self, timestamp, in_events, remove_events):
            raise ValueError("callback exploded")

    faults = _collector(pkg)
    rt.add_callback("pq", Boom())
    rt.add_callback("!S", faults)
    rt.get_input_handler("S").send(["A", 1])
    (sym, v, err), = _rows(faults)
    assert (sym, v) == ("A", 1) and "callback exploded" in err
    m.shutdown()


def test_depth_one_bypasses_pump():
    m = _manager("torch", 1)
    rt = m.create_siddhi_app_runtime(APP)
    out = _collector("torch")
    rt.add_callback("Out", out)
    qr = rt.query_runtimes["pq"]
    pump = rt.app_context.completion_pump
    qr.receive_batch(_batch(rt, [1]))
    assert _rows(out) == [("A", 1)]
    assert not pump.has_pending and pump.high_water == 0
    m.shutdown()


def test_defer_meta_maps_onto_pipeline_depth():
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    m.set_config_manager(siddhi_tpu_torch.InMemoryConfigManager(
        {"siddhi_tpu.defer_meta": "4"}))
    with pytest.warns(DeprecationWarning, match="defer_meta"):
        rt = m.create_siddhi_app_runtime(APP)
    assert rt.app_context.pipeline_depth == 4
    assert rt.app_context.defer_meta == 1
    out = _collector("torch")
    rt.add_callback("Out", out)
    rt.get_input_handler("S").send(["A", 1])
    assert _rows(out) == [("A", 1)]
    m.shutdown()


def test_depth_env_default_and_junk_spelling(monkeypatch):
    from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException

    monkeypatch.setenv("SIDDHI_TPU_PIPELINE_DEPTH", "6")
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    assert m.create_siddhi_app_runtime(APP).app_context.pipeline_depth == 6
    monkeypatch.setenv("SIDDHI_TPU_PIPELINE_DEPTH", "deep")
    with pytest.raises(SiddhiAppValidationException, match="SIDDHI_TPU_PIPELINE_DEPTH"):
        m.create_siddhi_app_runtime(APP)
    m.shutdown()


FLAGSHIP = """
@Async(buffer.size='64', batch.size='16')
define stream StockStream (symbol string, price float, volume long);
@info(name = 'bench')
from StockStream#window.length(50)
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
group by symbol insert into OutStream;
"""


def _run_depth(pkg, depth, feed):
    m = _manager(pkg, depth)
    rt = m.create_siddhi_app_runtime(FLAGSHIP)
    out = _collector(pkg)
    rt.add_callback("OutStream", out)
    h = rt.get_input_handler("StockStream")
    for item in feed:
        if item[0] == "cols":
            h.send_columns(item[1], timestamps=item[2])
        else:
            h.send(item[1], item[2])
    m.shutdown()        # the worker delivers its queue and drains first
    return out.rows, rt.app_context.completion_pump


def test_depths_give_the_reference_rows_in_dispatch_order():
    """@Async at depth 1, 4 and 8: the port's rows are identical across
    depths and equal the reference's at the same depth; at depth > 1 the
    pump held batches in flight."""
    feed = stock_feed(11, 6, 96, 9, n_events=40)
    ref = {d: _run_depth("jax", d, feed)[0] for d in (1, 4)}
    assert_rows_match(ref[4], ref[1])
    got = {}
    for d in (1, 4, 8):
        got[d], pump = _run_depth("torch", d, feed)
        assert (pump.high_water == 0) == (d == 1), (d, pump.high_water)
    assert len(got[1]) == 6 * 96 + 40
    for d in (1, 4, 8):
        assert got[d] == got[1], d
        assert_rows_match(got[d], ref[min(d, 4)])


def test_flush_owner_drains_one_owner_and_discard_all_drops_without_emitting():
    m = _manager("torch", 8)
    rt = m.create_siddhi_app_runtime(APP + """
        @info(name='other') from S select sym, v insert into Other;""")
    out, other = _collector("torch"), _collector("torch")
    rt.add_callback("Out", out)
    rt.add_callback("Other", other)
    qr, q2 = rt.query_runtimes["pq"], rt.query_runtimes["other"]
    pump = rt.app_context.completion_pump
    for i in range(2):
        b = _batch(rt, [i + 1], ts0=i)
        qr.receive_batch(b)
        q2.receive_batch(_batch(rt, [i + 1], ts0=i))
    with qr._lock:
        pump.flush_owner(qr)
    assert _rows(out) == [("A", 1), ("A", 3)] and other.rows == []
    assert pump.inflight(q2) == 2
    pump.discard_all()
    assert not pump.has_pending and pump.inflight(q2) == 0
    pump.flush()
    assert other.rows == []
    m.shutdown()
