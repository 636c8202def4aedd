"""The partitioned join engine on the port (``core/join/engine.py``), on
the CPU: the shapes of the reference's ``test_join_engine.py`` that do not
need snapshots or fan-out fusion (A.8), and the partition hash against the
reference's. Its snapshot shapes run in ``test_torch_persistence.py``.

- Eligibility and its reasons; the float-key shape keeps the broadcast
  probe and still pipelines.
- Engine == broadcast probe (``join_engine = legacy``) row for row at
  P in {1, 2, 4, 8}.
- Adaptive sub-window growth under a hot key: Wp grows, rows stay equal
  to the broadcast probe's; ``shrink_partitions`` gives it back.
- Overflows name their knob: ``join_partition_slack`` with growth off,
  ``window_capacity`` for a full time ring; the overflow bitmask decodes.
- Batches ride the CompletionPump at depth 4 and drain in dispatch order
  across both sides (the sequence lane checked at drain).
- ``hash_partition_dev`` gives the reference's partition for int32,
  int64, bool and string-id keys, as does the host mirror.
"""

import numpy as np
import pytest
import torch

from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager, StreamCallback
from siddhi_tpu_torch.core.event import HostBatch
from siddhi_tpu_torch.core.join import hash_partition_dev, hash_partition_np
from siddhi_tpu_torch.core.stream.junction import FatalQueryError
from torch_helpers import release_jax_programs  # noqa: F401 — autouse fixture


class Collector(StreamCallback):
    def __init__(self):
        super().__init__()
        self.rows = []

    def receive(self, events):
        self.rows.extend(tuple(e.data) for e in events)


APP = """
@app:name('japp')
define stream L (sym string, lv long);
define stream R (sym string, rv long);
@info(name='jq') from L#window.length(64) join R#window.length(64)
  on L.sym == R.sym
  select L.sym as sym, L.lv as lv, R.rv as rv insert into Out;
"""


def _build(depth=2, mode="device", P=8, extra=None, app=APP):
    m = SiddhiManager(device="cpu")
    cfg = {"siddhi_tpu.pipeline_depth": str(depth),
           "siddhi_tpu.join_engine": mode,
           "siddhi_tpu.join_partitions": str(P)}
    cfg.update(extra or {})
    m.set_config_manager(InMemoryConfigManager(cfg))
    rt = m.create_siddhi_app_runtime(app)
    c = Collector()
    rt.add_callback("Out", c)
    rt.start()
    return m, rt, c


def _side_batch(rt, stream, syms, vals, ts0=0):
    defn = rt.junctions[stream].definition
    col = "lv" if stream == "L" else "rv"
    return HostBatch.from_columns(
        {"sym": np.array(syms, dtype=object), col: np.asarray(vals, np.int64)},
        defn, rt.app_context.string_dictionary,
        timestamps=np.arange(ts0, ts0 + len(vals), dtype=np.int64))


def _feed(rt, lo, hi, seed=5):
    rng = np.random.default_rng(seed)
    picks, syms, vals = (rng.random(1000), rng.integers(0, 5, 1000),
                         rng.integers(0, 99, 1000))
    hl, hr = rt.get_input_handler("L"), rt.get_input_handler("R")
    for i in range(lo, hi):
        (hl if picks[i] < .5 else hr).send([f"S{syms[i]}", int(vals[i])])


# ------------------------------------------------------------ eligibility

def test_eligible_join_attaches_engine_and_is_pipeline_ok():
    m, rt, _c = _build()
    q = rt.query_runtimes["jq"]
    assert q.engine is not None and q.engine_reason is None
    assert q.pipeline_reason is None and q._pipeline_ok
    assert q.engine.partitioned_probe
    assert all(p.use_pidx for p in q.engine.plans.values())
    m.shutdown()


def test_auto_partitions_are_one_on_the_cpu():
    m, rt, _c = _build(P=0)
    assert rt.query_runtimes["jq"].engine.P == 1
    m.shutdown()


def test_legacy_mode_keeps_joins_synchronous():
    m, rt, _c = _build(mode="legacy")
    q = rt.query_runtimes["jq"]
    assert q.engine is None and "legacy" in (q.engine_reason or "")
    assert not q._pipeline_ok
    m.shutdown()


def test_ineligible_shapes_keep_legacy_with_reason():
    m, rt, _c = _build(app="""
define stream L (sym string, lv long);
define table T (sym string, tv long);
@info(name='tj') from L join T on L.sym == T.sym
  select L.sym as sym, T.tv as tv insert into Out;
""")
    q = rt.query_runtimes["tj"]
    assert q.engine is None and "shared-store" in q.engine_reason
    assert not q._pipeline_ok and "store" in q.pipeline_reason
    m.shutdown()


def test_float_key_keeps_broadcast_probe_but_still_pipelines():
    m, rt, _c = _build(app="""
define stream L (k double, lv long);
define stream R (k double, rv long);
@info(name='fj') from L#window.length(64) join R#window.length(64)
  on L.k == R.k select L.lv as lv, R.rv as rv insert into Out;
""")
    q = rt.query_runtimes["fj"]
    assert q.engine is not None and not q.engine.partitioned_probe
    assert q._pipeline_ok
    m.shutdown()


# ------------------------------------------------------ engine == legacy

@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_engine_equals_broadcast_probe_row_for_row(P):
    rows = {}
    for mode in ("device", "legacy"):
        m, rt, c = _build(mode=mode, P=P)
        _feed(rt, 0, 160)
        m.shutdown()
        rows[mode] = c.rows
    assert rows["device"] == rows["legacy"] and rows["device"]


def test_adaptive_growth_absorbs_skew_bit_identically_and_shrinks():
    skew_app = APP.replace("length(64)", "length(32)")

    def run(mode):
        m, rt, c = _build(extra={"siddhi_tpu.join_partition_slack": "1"},
                          app=skew_app, mode=mode, depth=1)
        hl, hr = rt.get_input_handler("L"), rt.get_input_handler("R")
        rng = np.random.default_rng(17)
        for i in range(120):                     # ~70% one hot key
            sym = "HOT" if rng.random() < .7 else f"S{rng.integers(0, 4)}"
            (hl if rng.random() < .5 else hr).send([sym, int(i)])
        if mode == "device":
            q = rt.query_runtimes["jq"]
            grown = max(p.Wp for p in q.engine.plans.values())
            assert grown > 4, f"sub-windows never grew (Wp={grown})"
        # the burst passes: spread keys refill both rings
        for i in range(200):
            (hl if i % 3 else hr).send([f"S{i % 97}", 1000 + i])
        if mode == "device":
            shrunk = q.engine.shrink_partitions()
            assert shrunk and all(new < old for old, new in shrunk.values())
        for i in range(60):
            (hl if i % 2 else hr).send([f"S{i % 20}", 5000 + i])
        m.shutdown()
        return c.rows

    assert run("device") == run("legacy")


# ------------------------------------------------------- overflow knobs

def test_partition_subwindow_overflow_names_slack_knob():
    m, rt, _c = _build(extra={"siddhi_tpu.join_partition_slack": "1",
                              "siddhi_tpu.join_partition_grow": "0"},
                       app=APP.replace("length(64)", "length(32)"))
    q = rt.query_runtimes["jq"]
    assert q.engine.partitioned_probe and not q.engine.grow
    h = rt.get_input_handler("L")
    with pytest.raises(FatalQueryError, match="join_partition_slack"):
        # 20 rows of ONE key into a Wp = 32/8 = 4 sub-window
        h.send_columns({"sym": np.array(["A"] * 20, dtype=object),
                        "lv": np.arange(20, dtype=np.int64)},
                       timestamps=np.arange(20, dtype=np.int64))
        rt.app_context.completion_pump.flush()
        h.send(["A", 99])
    m.shutdown()


def test_window_capacity_overflow_names_capacity_knob():
    m, rt, _c = _build(extra={"siddhi_tpu.window_capacity": "16"}, app="""
define stream L (sym string, lv long);
define stream R (sym string, rv long);
@info(name='jq') from L#window.time(10 sec) join R#window.length(8)
  on L.sym == R.sym select L.sym as sym, R.rv as rv insert into Out;
""")
    assert rt.query_runtimes["jq"].engine is not None
    h = rt.get_input_handler("L")
    with pytest.raises(FatalQueryError, match="window_capacity"):
        h.send_columns({"sym": np.array([f"S{i}" for i in range(40)], dtype=object),
                        "lv": np.arange(40, dtype=np.int64)})
        rt.app_context.completion_pump.flush()
        h.send(["A", 99])
    m.shutdown()


def test_overflow_knob_msg_decodes_bitmask():
    m, rt, _c = _build()
    q = rt.query_runtimes["jq"]
    assert "window_capacity" in q.overflow_knob_msg(1)
    assert "index_probe_width" in q.overflow_knob_msg(2)
    assert "join_partition_slack" in q.overflow_knob_msg(4)
    assert "distinct_values_capacity" in q.overflow_knob_msg(8)
    both = q.overflow_knob_msg(5)
    assert "window_capacity" in both and "join_partition_slack" in both
    m.shutdown()


# ------------------------------------------------------- pump + sequence

def test_join_batches_ride_pump_and_drain_in_order():
    m, rt, c = _build(depth=4)
    q = rt.query_runtimes["jq"]
    pump = rt.app_context.completion_pump
    q.process_side_batch("right", _side_batch(rt, "R", ["A"], [100]))
    q.process_side_batch("left", _side_batch(rt, "L", ["A"], [1], ts0=1))
    q.process_side_batch("left", _side_batch(rt, "L", ["A"], [2], ts0=2))
    assert pump.inflight(q) == 3 and c.rows == []
    pump.flush_owner(q)
    assert c.rows == [("A", 1, 100), ("A", 2, 100)]
    assert q._drain_seq == 3 and q.seq_breaks == 0
    m.shutdown()


# --------------------------------------------------------------- hashing

def test_partition_hash_equals_the_reference():
    import jax.numpy as jnp

    from siddhi_tpu.core.join.engine import hash_partition_dev as ref_hash

    rng = np.random.default_rng(3)
    keys = {
        "int32": rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int64).astype(np.int32),
        "int64": np.concatenate([rng.integers(-2 ** 63, 2 ** 63 - 1, 4096, dtype=np.int64),
                                 np.array([0, -1, 2 ** 63 - 1, -2 ** 63], np.int64)]),
        "bool": np.array([True, False, True]),
        "string_id": np.arange(0, 20000, 7, dtype=np.int32),
    }
    for name, vals in keys.items():
        for P in (1, 2, 8, 64):
            want = np.asarray(ref_hash(jnp.asarray(vals), P))
            got = hash_partition_dev(torch.from_numpy(vals), P).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{name} P={P}")
            np.testing.assert_array_equal(hash_partition_np(vals, P), want,
                                          err_msg=f"{name} P={P} host mirror")
