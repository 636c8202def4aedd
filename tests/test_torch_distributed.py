"""The multi-process half of the port in one process, on the CPU
(``parallel/distributed.py``, ``parallel/mesh.shard_query_step``, the
supervisor's peer half): each check against the reference's semantics or
rows.

- ``guarded_pull``: the bound (a stalled pull raises ``ClusterPeerError``
  matching ``peer.*snapshot`` well before the stall ends), the fast path,
  the cap on outstanding pulls and the fault hook
  (``tests/test_multihost.py:357-379``).
- ``initialize_cluster`` and ``process_info`` on a one-process gloo group
  (on ``127.0.0.1`` and a free port); the meshes it gives.
- The four shapes of ``tests/test_sharding.py`` (a group-by window, a
  partitioned keyed window, a partitioned pattern and an absent pattern
  with TIMER sweeps): the port's ``shard_query_step`` over
  ``make_mesh(8)`` gives the reference's sharded rows.
- ``test_resilience.py::test_peer_death_triggers_full_recovery_protocol``
  on the port: every collector's rows equal the reference's run.
- ``drop_peer``/``restore_peer`` and the supervisor's peer counters.
- The ``shard`` and peer families on ``/metrics``.

Tolerance (``torch_helpers``): exact for ints, strings and order; floats
to rtol 1e-12. The 2- and 4-process runs are ``test_torch_multiprocess.py``.
"""

import socket
import time

import numpy as np
import pytest
import torch

from torch_helpers import (
    PARTITIONED_APP,
    Run,
    assert_rows_match,
    port_corpus,
    release_jax_programs,  # noqa: F401 — autouse fixture: frees JAX programs
    stock_feed,
)

from siddhi_tpu_torch.parallel import distributed

torch.set_num_threads(1)

SHARDING_SHAPES = ["test_sharded_group_by_window_aggregation",
                   "test_sharded_partitioned_keyed_window",
                   "test_sharded_partitioned_nfa_pattern",
                   "test_sharded_partitioned_absent_pattern"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ guarded_pull

def test_guarded_pull_times_out_with_labeled_error():
    """A pull whose wait stalls longer than the bound raises
    ClusterPeerError with the recovery hint, long before the stall ends;
    the abandoned wait is counted until it ends."""
    t0 = time.time()
    with pytest.raises(distributed.ClusterPeerError, match="peer.*snapshot"):
        distributed.guarded_pull(torch.zeros(3), 0.3, what="unit step",
                                 wait=lambda: time.sleep(1.5))
    assert time.time() - t0 < 1.2
    assert distributed.outstanding_pulls() >= 1       # the parked wait
    deadline = time.time() + 10
    while distributed.outstanding_pulls() and time.time() < deadline:
        time.sleep(0.05)
    assert distributed.outstanding_pulls() == 0


def test_guarded_pull_fast_path_reads_tensors_to_numpy():
    v = distributed.guarded_pull(torch.arange(3), 5.0)
    assert isinstance(v, np.ndarray) and v.tolist() == [0, 1, 2]
    pair = distributed.guarded_pull([torch.ones(2), torch.zeros(1, dtype=torch.int64)], 5.0)
    assert [p.tolist() for p in pair] == [[1.0, 1.0], [0]]


def test_guarded_pull_fails_fast_at_the_cap(monkeypatch):
    """At ``_MAX_OUTSTANDING_PULLS`` parked pulls the next one raises at
    once, naming the cap, without starting a thread."""
    monkeypatch.setattr(distributed, "_outstanding_pulls",
                        distributed._MAX_OUTSTANDING_PULLS)
    t0 = time.time()
    with pytest.raises(distributed.ClusterPeerError, match="cap 32"):
        distributed.guarded_pull(torch.zeros(1), 5.0, what="capped")
    assert time.time() - t0 < 0.5


def test_drop_and_restore_peer_arm_the_fault_hook():
    """``drop_peer`` makes every pull raise at once, labeled; ``restore_peer``
    and ``clear`` disarm it (the reference's ``faults.py:208-226``)."""
    from siddhi_tpu_torch.resilience import FaultInjector

    faults = FaultInjector()
    faults.drop_peer("peer 1 gone")
    assert distributed._fault_hook is not None
    t0 = time.time()
    with pytest.raises(distributed.ClusterPeerError,
                       match="query 'q' step: peer 1 gone.*snapshot"):
        distributed.guarded_pull(torch.zeros(1), 30.0, what="query 'q' step")
    assert time.time() - t0 < 1.0
    faults.restore_peer()
    assert distributed._fault_hook is None
    assert distributed.guarded_pull(torch.ones(1), 5.0).tolist() == [1.0]
    faults.drop_peer()
    faults.clear()
    assert distributed._fault_hook is None


# --------------------------------------------------------- process group

def test_process_info_on_a_one_process_gloo_group():
    """A one-process gloo group: the reference's four keys, a global mesh
    of its local shards, and a sharded query over it (the reference's
    ``test_distributed_single_process_cluster``)."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.parallel.mesh import shard_query_step

    assert distributed.process_info() == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}
    distributed.initialize_cluster(f"127.0.0.1:{_free_port()}", 1, 0,
                                   max_missing_heartbeats=2, device="cpu")
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert distributed.process_info() == {
            "process_index": 0, "process_count": 1, "local_devices": 1,
            "global_devices": 1}
        mesh = distributed.global_mesh(4)
        assert (mesh.n, mesh.process_count, mesh.local, mesh.first) == (4, 1, 4, 0)
        assert mesh.device == torch.device("cpu")
        assert distributed.local_survivor_mesh().n == 1
        m = SiddhiManager(device="cpu")
        rt = m.create_siddhi_app_runtime(
            "define stream S (sym string, v int); @info(name='q') "
            "from S select sym, sum(v) as s group by sym insert into Out;")
        seen = []

        class C(StreamCallback):
            def receive(self, events):
                seen.extend(tuple(e.data) for e in events)

        rt.add_callback("Out", C())
        q = rt.query_runtimes["q"]
        shard_query_step(q, distributed.global_mesh())
        assert q._shard_mesh is not None and q._route_layout is None
        h = rt.get_input_handler("S")
        h.send(["a", 1])
        h.send(["b", 2])
        h.send(["a", 3])
        m.shutdown()
        assert seen == [("a", 1), ("b", 2), ("a", 4)]
    finally:
        distributed.shutdown_cluster()
    assert not torch.distributed.is_initialized()


def test_initialize_cluster_needs_a_card_by_default():
    """No device means this process's card: here there is none, and no
    quiet fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        distributed.initialize_cluster("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()


# ------------------------------------------------- the sharded shapes

def _sharded_rows(mod, name):
    """Run one of test_sharding.py's scenarios in ``mod`` (the reference or
    its port binding) and return its sharded runtime's rows."""
    built = []
    orig = mod._build

    def spy(app, out):
        res = orig(app, out)
        built.append(res[2])
        return res

    mod._build = spy
    try:
        getattr(mod, name)()
    finally:
        mod._build = orig
    return [(0, tuple(e.data), e.is_expired) for e in built[-1].events]


@pytest.mark.parametrize("name", SHARDING_SHAPES)
def test_sharding_shapes_equal_the_reference(name):
    import tests.test_sharding as ref

    port = port_corpus("test_sharding")[0]
    got = _sharded_rows(port, name)
    want = _sharded_rows(ref, name)
    assert got
    assert_rows_match(got, want)


def test_shard_query_step_keeps_the_state_whole_on_one_process():
    """One process of n logical shards: the state stays whole (nothing to
    gather), the mesh is recorded for the bounded pulls, and capacity
    growth re-invokes the sharding."""
    from siddhi_tpu_torch.parallel.mesh import make_mesh, shard_query_step

    feed = stock_feed(seed=4, n_batches=2, batch=64, n_symbols=40)
    run = Run("torch", PARTITIONED_APP.format(W=4), "OutStream", "bench")
    q = run.query
    mesh = make_mesh(8)
    calls = []
    import siddhi_tpu_torch.parallel.mesh as tmesh

    orig = tmesh.shard_query_step

    def spy(runtime, m, donate=True):
        calls.append(m)
        return orig(runtime, m, donate)

    tmesh.shard_query_step = spy
    try:
        step, state = shard_query_step(q, mesh)
        assert q._shard_mesh is mesh and q._route_layout is None
        got = run.feed("StockStream", feed).close()
    finally:
        tmesh.shard_query_step = orig
    assert calls and all(m is mesh for m in calls)     # growth re-invoked it
    want = Run("jax", PARTITIONED_APP.format(W=4), "OutStream", "bench").feed(
        "StockStream", feed).close()
    assert_rows_match(got, want)


# ------------------------------------------------------- peer recovery

def _record_collectors(mod):
    made = []
    orig = mod.Collector.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        made.append(self)

    mod.Collector.__init__ = init
    return made, orig


def test_peer_death_recovery_protocol_rows_equal_the_reference():
    """``drop_peer`` makes the sharded step's bounded pull raise
    ClusterPeerError; the supervisor abandons the runtime, rebuilds it,
    restores the last revision and replays the WAL suffix. Every
    collector of the scenario (the doomed runtime's, the rebuilt one's,
    the uninterrupted runs') holds the reference's rows."""
    import tests.test_resilience as ref

    port = port_corpus("test_resilience")[0]
    rows = {}
    for pkg, mod in (("torch", port), ("jax", ref)):
        made, orig = _record_collectors(mod)
        try:
            mod.test_peer_death_triggers_full_recovery_protocol()
        finally:
            mod.Collector.__init__ = orig
        rows[pkg] = [c.rows() for c in made]
    assert len(rows["torch"]) == len(rows["jax"]) >= 2
    for got, want in zip(rows["torch"], rows["jax"]):
        assert_rows_match([(0, tuple(r), False) for r in got],
                          [(0, tuple(r), False) for r in want])


# ------------------------------------------------------------ /metrics

def test_shard_and_peer_families_on_metrics():
    """A routed query renders ``siddhi_shard_rows{query,shard}`` (a gauge
    a shard, summing to the batch's rows) and ``siddhi_shard_exchange_ms``;
    the peer counters are declared at 0 and count a peer failure; the
    bounded pull's gauge is on the process registry."""
    import re

    from siddhi_tpu_torch.observability.export import prometheus_text
    from siddhi_tpu_torch.resilience import PeerRecovery

    feed = stock_feed(seed=5, n_batches=1, batch=64, n_symbols=12)
    run = Run("torch", "@app:statistics('BASIC') " + PARTITIONED_APP.format(W=4),
              "OutStream", "bench", routed_n=4, rows_per_shard=64)
    run.feed("StockStream", feed)
    text = prometheus_text(run.manager)
    shard_rows = [int(float(v)) for v in re.findall(
        r'^siddhi_shard_rows\{[^}]*query="bench"[^}]*\} (\S+)$', text, re.M)]
    assert len(shard_rows) == 4 and sum(shard_rows) == 64
    assert re.search(r'siddhi_shard_exchange_ms\w*\{[^}]*query="bench"', text)
    assert re.search(r'resilience\.peer_failures"?[^\n]* 0', text)
    assert re.search(r'resilience\.peer_recoveries"?[^\n]* 0', text)
    assert "cluster.outstanding_pulls" in text or "outstanding_pulls" in text
    sup = run.rt.supervise(interval_s=60.0, peer_recovery=None)
    sup.notify_error(None, distributed.ClusterPeerError("peer gone"))
    assert re.search(r'resilience\.peer_failures"?[^\n]* 1', prometheus_text(run.manager))
    assert isinstance(PeerRecovery(lambda: None).rebuild, type(lambda: None))
    sup.stop()
    run.close()


# ------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the exchange and the distinct scan are "
                    "CUDA C++ with no CPU mode, and NCCL needs the card")
    return torch.device("cuda", 0)


def _card_rows(app, query, out, drive, mesh=None, key_slots=1024, capacity=None):
    """One card run of a partitioned app driven by ``drive(rt)``, routed
    over ``mesh`` when given; (rows, (the query's routed dispatches,
    captured, graph replays))."""
    from torch_helpers import make_collector

    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step

    dev = torch.device("cuda", 0)
    m = SiddhiManager(device=dev)
    rt = m.create_siddhi_app_runtime(app)
    c = make_collector(StreamCallback)
    rt.add_callback(out, c)
    q = rt.query_runtimes[query]
    if key_slots is not None:
        q.selector_plan.num_keys = key_slots
        q._win_keys = key_slots
    for spec in q.selector_plan.specs if capacity else ():
        spec.distinct_capacity = capacity
    if mesh is not None:
        device_route_query_step(q, mesh, rows_per_shard=4096)
    drive(rt)
    rl = q._route_layout
    graph = getattr(q._step, "graph", None)
    facts = (rl.dispatches if rl is not None else 0, q.captured,
             graph.replays if graph is not None else 0)
    m.shutdown()
    return c.rows, facts


@pytest.mark.cuda
def test_routed_flagship_over_the_global_mesh_on_the_card():
    """Phase 31's gate 3 at a cut size: a world of one over NCCL, the
    routed ×4 flagship over ``global_mesh(4)`` == unrouted on the card,
    K8 launched once a routed dispatch, the step captured."""
    dev = _card()
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    from torch_helpers import send_feed

    feed = stock_feed(seed=6, n_batches=4, batch=8192, n_symbols=500)

    def drive(rt):
        send_feed(rt, "StockStream", feed)

    distributed.initialize_cluster(f"127.0.0.1:{_free_port()}", 1, 0, device=dev)
    try:
        assert torch.distributed.get_backend() == "nccl"
        want, _ = _card_rows(PARTITIONED_APP.format(W=8), "bench", "OutStream", drive)
        ring_exchange.launches = 0
        got, (dispatches, captured, replays) = _card_rows(
            PARTITIONED_APP.format(W=8), "bench", "OutStream", drive,
            mesh=distributed.global_mesh(4))
        assert ring_exchange.launches == dispatches == 4
        assert captured and replays == 3
        assert_rows_match(got, want)
    finally:
        distributed.shutdown_cluster()


@pytest.mark.cuda
def test_routed_distinct_and_join_on_the_card():
    """Phase 31's gate 4 at a cut size: distinct value tables routed ×4
    with the scan inside the routed step's graph (4 launches a dispatch)
    == unrouted; the partitioned join routed ×4 == unrouted."""
    import numpy as np

    dev = _card()
    from siddhi_tpu_torch.ops.distinct import distinct_scan
    from siddhi_tpu_torch.parallel.mesh import make_mesh

    app = """
    define stream StockStream (symbol string, price float, volume long);
    partition with (symbol of StockStream)
    begin
    @info(name = 'bench')
    from StockStream#window.length(64)
    select symbol, distinctCount(volume) as volumes, avg(price) as avgPrice
    insert into OutStream;
    end;
    """
    from torch_helpers import send_feed

    feed = stock_feed(seed=7, n_batches=4, batch=8192, n_symbols=500)

    def drive(rt):
        send_feed(rt, "StockStream", feed)

    want, _ = _card_rows(app, "bench", "OutStream", drive, capacity=128)
    distinct_scan.launches = 0
    got, (dispatches, captured, replays) = _card_rows(
        app, "bench", "OutStream", drive, mesh=make_mesh(4, dev), capacity=128)
    assert captured and replays == 3 and dispatches == 4
    assert distinct_scan.launches == 4 * dispatches
    assert_rows_match(got, want)

    rng = np.random.default_rng(8)
    syms = np.array([f"S{i}" for i in range(200)], dtype=object)
    items, ts = [], 0
    for _ in range(3):
        for s, col in (("L", "lv"), ("R", "rv")):
            items.append((s, {"sym": syms[rng.integers(0, 200, 2048)],
                              col: rng.integers(0, 30, 2048)},
                          np.arange(ts, ts + 2048, dtype=np.int64)))
            ts += 2048
    join = """
    define stream L (sym string, lv long);
    define stream R (sym string, rv long);
    partition with (sym of L, sym of R)
    begin
      @info(name='pj') from L#window.length(8) join R#window.length(8)
        on L.lv > R.rv
        select L.sym as sym, L.lv as lv, R.rv as rv insert into Out;
    end;
    """
    def drive_j(rt):
        for stream, cols, t in items:
            rt.get_input_handler(stream).send_columns(cols, timestamps=t)

    want_j, _ = _card_rows(join, "pj", "Out", drive_j, key_slots=None)
    got_j, (jd, _c, _r) = _card_rows(join, "pj", "Out", drive_j,
                                     mesh=make_mesh(4, dev), key_slots=None)
    assert want_j and jd == len(items)
    assert_rows_match(got_j, want_j)
