"""The port's process-global program cache (``core/util/program_cache.py``)
and its step instrument (``observability/telemetry.InstrumentedJit``), on
the CPU.

The seven scenarios of ``tests/test_program_cache.py`` drive the port
through the module's own apps and checks (``torch_helpers.port_corpus``;
the family-inventory scenario reads the port's ``analysis/step_registry``
and call sites). Then: two apps whose string dictionaries give 'IBM'
different ids must not share a ``sym == 'IBM'`` step, and each gets the
reference's rows; window states stay private across sharers through
snapshot and restore, as the reference's do; a routed x4 step shared by
two apps gives each its unrouted rows. On the card a shared graph equals
a private graph equals the eager step (a ``cuda`` test).
"""

import numpy as np
import pytest
import torch

from torch_helpers import (  # noqa: F401 — autouse fixture
    PARTITIONED_APP, assert_rows_match, make_collector, port_corpus,
    release_jax_programs, stock_feed, send_feed)

MOD, SCENARIOS = port_corpus("test_program_cache")


def test_every_scenario_is_collected():
    assert len(SCENARIOS) == 7, SCENARIOS


@pytest.mark.parametrize("name", SCENARIOS)
def test_program_cache_corpus_on_port(name):
    getattr(MOD, name)()


def _cache():
    from siddhi_tpu_torch.core.util import program_cache

    return program_cache.cache()


def _manager(pkg, config=None):
    if pkg == "jax":
        import siddhi_tpu
        from siddhi_tpu.core.util.config import InMemoryConfigManager

        m, base = siddhi_tpu.SiddhiManager(), siddhi_tpu.StreamCallback
    else:
        import siddhi_tpu_torch
        from siddhi_tpu_torch import InMemoryConfigManager

        m, base = siddhi_tpu_torch.SiddhiManager(device="cpu"), siddhi_tpu_torch.StreamCallback
    if config:
        m.set_config_manager(InMemoryConfigManager(dict(config)))
    return m, base


# app 2 plans a query with 'AAA' first, so its dictionary gives 'IBM' id 1
# where app 1's gives it id 0; the query under test is the same text
IBM_Q = ("@info(name = 'q') from S[sym == 'IBM'] select sym, v "
         "insert into O;\n")
IBM_APP_1 = "@app:name('ibm1') define stream S (sym string, v long);\n" + IBM_Q
IBM_APP_2 = ("@app:name('ibm2') define stream T (sym string);\n"
             "define stream S (sym string, v long);\n"
             "@info(name = 'q0') from T[sym == 'AAA'] select sym insert into X;\n"
             + IBM_Q)
IBM_FEED = [("AAA", 1), ("IBM", 2), ("XYZ", 3), ("IBM", 4), ("AAA", 5)]


def _ibm_rows(pkg):
    m, base = _manager(pkg)
    out = []
    for app in (IBM_APP_1, IBM_APP_2):
        rt = m.create_siddhi_app_runtime(app)
        cb = make_collector(base)
        rt.add_callback("O", cb)
        out.append((rt, cb))
    for rt, _cb in out:
        h = rt.get_input_handler("S")
        for i, row in enumerate(IBM_FEED):
            h.send(100 + i, list(row))
    entries = [] if pkg == "jax" else [
        e for e in _cache().snapshot()["entries"] if "query.q.step" in e["keys"]]
    ids = [rt.app_context.string_dictionary.encode("IBM") for rt, _ in out]
    m.shutdown()
    return [cb.rows for _rt, cb in out], entries, ids


def test_dictionary_ids_enter_the_witness():
    """``sym == 'IBM'`` compiles to a comparison with the id the app's own
    dictionary gave 'IBM' at plan time; the two apps' ids differ, so their
    steps must not share (a witness without the encoded constants would
    hand app 2 app 1's step and app 2 would emit its 'AAA' rows)."""
    _cache().drain()
    want, _, _ = _ibm_rows("jax")
    got, entries, ids = _ibm_rows("torch")
    assert ids == [0, 1]
    for g, w in zip(got, want):
        assert_rows_match(g, w)
    assert [r[1] for r in got[1]] == [("IBM", 2), ("IBM", 4)]
    assert len(entries) == 2 and all(e["refcount"] == 1 for e in entries)


WINDOW_APP = """@app:name('{name}')
define stream S (sym string, price double, vol long);
@info(name = 'w')
from S#window.length(4)
select sym, sum(vol) as total, avg(price) as ap
group by sym
insert into Out;
"""


def _window_feed(seed, n):
    rng = np.random.default_rng(seed)
    return [(f"K{int(rng.integers(0, 3))}", float(np.round(rng.random() * 10, 2)),
             int(rng.integers(1, 50))) for _ in range(n)]


def _window_run(pkg):
    """Two apps of one program on different feeds: app 1 is snapshotted
    after its 6th event, runs on, is restored, and replays its tail."""
    m, base = _manager(pkg)
    rts, cbs = [], []
    for name in ("pw1", "pw2"):
        rt = m.create_siddhi_app_runtime(WINDOW_APP.format(name=name))
        cb = make_collector(base)
        rt.add_callback("Out", cb)
        rts.append(rt)
        cbs.append(cb)
    f1, f2 = _window_feed(1, 10), _window_feed(2, 10)
    h1, h2 = (rt.get_input_handler("S") for rt in rts)
    snap = None
    for i in range(10):
        h1.send(100 + i, list(f1[i]))
        h2.send(100 + i, list(f2[i]))
        if i == 5:
            snap = rts[0].snapshot()
    rts[0].restore(snap)
    for i in range(6, 10):
        h1.send(200 + i, list(f1[i]))
    shared = None
    if pkg == "torch":
        (entry,) = [e for e in _cache().snapshot()["entries"] if "query.w.step" in e["keys"]]
        shared = entry["refcount"]
    m.shutdown()
    return [cb.rows for cb in cbs], shared


def test_window_state_private_across_sharers_and_restore():
    _cache().drain()
    want, _ = _window_run("jax")
    got, refcount = _window_run("torch")
    assert refcount == 2
    for g, w in zip(got, want):
        assert_rows_match(g, w)
    assert _cache().size() == 0


def _routed_rows(seed, routed, config=None):
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    m, base = _manager("torch", config)
    rt = m.create_siddhi_app_runtime(PARTITIONED_APP.format(W=8))
    cb = make_collector(base)
    rt.add_callback("OutStream", cb)
    if routed:
        device_route_query_step(rt.query_runtimes["bench"], make_mesh(4), rows_per_shard=64)
    return m, rt, cb, stock_feed(seed, 3, 32, 6, n_events=3)


def test_routed_step_shared_by_two_apps():
    """The routed x4 step (family ``device_routed``, its layout the extra
    witness) of two apps is one entry; each app's rows equal its own
    unrouted run's."""
    _cache().drain()
    runs = [_routed_rows(seed, routed=True) for seed in (3, 4)]
    for m, rt, cb, feed in runs:
        send_feed(rt, "StockStream", feed)
    (entry,) = [e for e in _cache().snapshot()["entries"] if e["family"] == "device_routed"]
    assert entry["refcount"] == 2 and entry["hits"] == 1
    jits = [rt.app_context.telemetry.snapshot()["jit"]["query.bench.step"] for _m, rt, _c, _f in runs]
    assert [j["compiles"] for j in jits] == [1, 0] and jits[1]["hits"] >= 1
    for (m, rt, cb, feed), seed in zip(runs, (3, 4)):
        m.shutdown()
        um, urt, ucb, ufeed = _routed_rows(seed, routed=False)
        send_feed(urt, "StockStream", ufeed)
        um.shutdown()
        assert len(cb.rows) == len(ucb.rows) > 0
        assert_rows_match(cb.rows, ucb.rows)
    assert _cache().size() == 0


@pytest.mark.cuda
def test_cuda_shared_graph_equals_private_equals_eager():
    """On the card: two apps of the global flagship's shape on different
    feeds, with the cache on (one shared graph, captured over the entry's
    slot), off (a private graph each) and eager: the rows are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the steps replay CUDA graphs")
    import siddhi_tpu_torch
    from siddhi_tpu_torch import InMemoryConfigManager

    app = """@app:name('{name}')
    define stream StockStream (symbol string, price float, volume long);
    @info(name = 'bench')
    from StockStream#window.length(16)
    select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
    group by symbol insert into OutStream;
    """

    def run(cache_on, eager=False):
        _cache().drain()
        m = siddhi_tpu_torch.SiddhiManager(device="cuda")
        m.set_config_manager(InMemoryConfigManager(
            {"siddhi_tpu.program_cache": "true" if cache_on else "false"}))
        rows = []
        for i in range(2):
            rt = m.create_siddhi_app_runtime(app.format(name=f"g{i}"))
            cb = make_collector(siddhi_tpu_torch.StreamCallback)
            rt.add_callback("OutStream", cb)
            q = rt.query_runtimes["bench"]
            send_feed(rt, "StockStream", stock_feed(20 + i, 1, 256, 20))
            if eager:
                q.captured = False
            send_feed(rt, "StockStream", stock_feed(30 + i, 4, 256, 20))
            assert q.captured == (not eager)
            rows.append(cb)
        snap = _cache().snapshot()
        m.shutdown()
        return [cb.rows for cb in rows], snap

    shared, snap = run(True)
    assert snap["size"] == 1 and snap["entries"][0]["refcount"] == 2
    assert snap["entries"][0]["captures"] == 1
    private, snap_off = run(False)
    assert snap_off["size"] == 0
    eager, _ = run(True, eager=True)
    for a, b, c in zip(shared, private, eager):
        assert a == b == c
