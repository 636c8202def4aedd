"""The port across processes, on the CPU: spawned gloo groups (on
``127.0.0.1`` and a free port) run the key-sharded and routed steps, and
every process's rows are held against the reference's single-process run.

Every process runs the same program on the same events (the
multi-controller contract); the children import ``siddhi_tpu_torch``
only, and each asserts at its end that neither ``jax`` nor ``siddhi_tpu``
was imported. One group serves several checks:

- 2 processes: ``shard_query_step`` over ``global_mesh()`` with the
  flagship of ``tests/test_multihost.py`` (fused, whose state is all
  unkeyed, and generic, whose selector shards by group key behind the
  global window), the partitioned flagship and the partitioned pattern;
  the routed flagship at 2 x 2 shards; routed distinct value tables; the
  routed partitioned join; a revision persisted at 2 processes, restored
  here into 1 process x 4 shards, into an unrouted runtime and into the
  reference.
- 4 processes: the routed flagship at 4 x 1 shards.
- 2 processes, peer death: process 1 exits abruptly; the survivor's next
  step yields a fault-stream event naming the peer within 60 s
  (``cluster_step_timeout`` 4).

Tolerance (``torch_helpers``): ints, strings, timestamps and order exact;
floats to rtol 1e-12.
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from torch_helpers import (
    DISTINCT_GK_APP,
    PARTITIONED_APP,
    Run,
    assert_rows_match,
    release_jax_programs,  # noqa: F401 — autouse fixture: frees JAX programs
    side_feed,
    stock_feed,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

FLAGSHIP = """
define stream S (symbol string, price double, volume long);
@info(name = 'q')
from S#window.length(8)
select symbol, avg(price) as ap, sum(volume) as tv
group by symbol
insert into Out;
"""

PATTERN = """
@app:playback
define stream A (k string, v double);
define stream B (k string, v double);
partition with (k of A, k of B)
begin
  @info(name = 'q')
  from every e1=A -> e2=B[e2.v > e1.v] within 5 sec
  select e1.v as v1, e2.v as v2
  insert into Out;
end;
"""

DISTINCT = """
@app:name('distinctApp')
define stream S (symbol string, page string, v long);
partition with (symbol of S)
begin
  @info(name = 'q')
  from S#window.length(3)
  select symbol, distinctCount(page) as pages, distinctCount(v) as vals
  insert into Out;
end;
"""

JOIN = """
define stream L (sym string, lv long);
define stream R (sym string, rv long);
partition with (sym of L, sym of R)
begin
  @info(name='pj') from L#window.length(8) join R#window.length(8)
    on L.lv > R.rv
    select L.sym as sym, L.lv as lv, R.rv as rv insert into Out;
end;
"""

PERSIST_APP = "@app:name('mpPersist')\n" + PARTITIONED_APP.format(W=8)

# the feeds, made from a seed in every process alike (numpy only)
FEEDS = textwrap.dedent('''
    import numpy as np

    def flagship_sends(h):
        for i in range(96):
            h.send(1000 + i, [f"K{i % 24}", float(i % 13) + 0.5, int(i)])

    def pattern_sends(ha, hb):
        t = 1000
        for i in range(48):
            k = f"P{(i * 7) % 16}"
            va = float((i * 3) % 11)
            ha.send(t, [k, va])
            hb.send(t + 1, [k, va + (1.0 if i % 3 else -1.0)])
            t += 50

    def page_feed(seed, n_batches, batch):
        rng = np.random.default_rng(seed)
        syms = np.array([f"S{i}" for i in range(7)], dtype=object)
        pages = np.array([f"p{i}" for i in range(5)], dtype=object)
        feed, ts = [], 0
        for _ in range(n_batches):
            feed.append(("cols", {"symbol": syms[rng.integers(0, 7, batch)],
                                  "page": pages[rng.integers(0, 5, batch)],
                                  "v": rng.integers(0, 4, batch)},
                         np.arange(ts, ts + batch, dtype=np.int64)))
            ts += batch
        return feed

    def join_sends(rt, lo, hi, n_sym=9, seed=11):
        rng = np.random.default_rng(seed)
        picks, syms, vals = (rng.random(1000), rng.integers(0, n_sym, 1000),
                             rng.integers(0, 30, 1000))
        hl, hr = rt.get_input_handler("L"), rt.get_input_handler("R")
        for i in range(lo, hi):
            (hl if picks[i] < .5 else hr).send([f"S{syms[i]}", int(vals[i])])
''')

WORKER = FEEDS + textwrap.dedent('''
    import os
    import pickle
    import sys
    import time

    root, port, P, rank, out, checks = sys.argv[1:7]
    P, rank = int(P), int(rank)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch

    torch.set_num_threads(1)
    from siddhi_tpu_torch.parallel import distributed

    distributed.initialize_cluster(f"127.0.0.1:{port}", P, rank,
                                   max_missing_heartbeats=3, device="cpu")
    import siddhi_tpu_torch
    from siddhi_tpu_torch.core import context
    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, shard_query_step
    from torch_helpers import (DISTINCT_GK_APP, PARTITIONED_APP, fusion,
                               make_collector, send_feed, side_feed, stock_feed)

    ARGS = pickle.loads(bytes.fromhex(sys.argv[7]))
    res = {"info": distributed.process_info()}

    def build(app, out_stream, fused=True, store=None):
        with fusion(context, fused):
            m = siddhi_tpu_torch.SiddhiManager(device="cpu")
            if store is not None:
                m.set_persistence_store(store)
            rt = m.create_siddhi_app_runtime(app)
        c = make_collector(siddhi_tpu_torch.StreamCallback)
        rt.add_callback(out_stream, c)
        return m, rt, c

    def sharded_flagship(fused):
        m, rt, c = build(ARGS["flagship"], "Out", fused)
        q = rt.query_runtimes["q"]
        shard_query_step(q, distributed.global_mesh())
        split = q._route_layout.split if q._route_layout is not None else None
        flagship_sends(rt.get_input_handler("S"))
        m.shutdown()
        return split, c.rows

    def run(name):
        if name == "flagship":
            return sharded_flagship(True)
        if name == "flagship_generic":
            return sharded_flagship(False)
        if name == "partitioned":
            m, rt, c = build(PARTITIONED_APP.format(W=8), "OutStream")
            q = rt.query_runtimes["bench"]
            shard_query_step(q, distributed.global_mesh())
            send_feed(rt, "StockStream", stock_feed(**ARGS["stock"]))
            m.shutdown()
            return q._route_layout.split, c.rows
        if name == "pattern":
            m, rt, c = build(ARGS["pattern"], "Out")
            q = rt.query_runtimes["q"]
            shard_query_step(q, distributed.global_mesh())
            pattern_sends(rt.get_input_handler("A"), rt.get_input_handler("B"))
            m.shutdown()
            return q._route_layout.split, c.rows
        if name.startswith("routed"):
            local = int(name.split("_")[1])
            m, rt, c = build(PARTITIONED_APP.format(W=8), "OutStream")
            q = rt.query_runtimes["bench"]
            device_route_query_step(q, distributed.global_mesh(local), rows_per_shard=256)
            send_feed(rt, "StockStream", stock_feed(**ARGS["stock"]))
            m.shutdown()
            return (q._route_layout.n, q._route_layout.L), c.rows
        if name == "lut":
            m, rt, c = build(DISTINCT_GK_APP, "Out")
            q = rt.query_runtimes["q"]
            device_route_query_step(q, distributed.global_mesh(2), rows_per_shard=256)
            send_feed(rt, "S", side_feed(**ARGS["side"]))
            m.shutdown()
            return q._route_layout.use_lut, c.rows
        if name == "distinct":
            m, rt, c = build(ARGS["distinct"], "Out")
            q = rt.query_runtimes["q"]
            device_route_query_step(q, distributed.global_mesh(2), rows_per_shard=96)
            send_feed(rt, "S", page_feed(5, 3, 96))
            m.shutdown()
            return q._route_layout.n, c.rows
        if name == "join":
            m, rt, c = build(ARGS["join"], "Out")
            q = rt.query_runtimes["pj"]
            device_route_query_step(q, distributed.global_mesh(1), rows_per_shard=256)
            join_sends(rt, 0, 200)
            m.shutdown()
            return q._route_layout.n, c.rows
        if name == "persist":
            store = InMemoryPersistenceStore()
            m, rt, c = build(ARGS["persist_app"], "OutStream", store=store)
            q = rt.query_runtimes["bench"]
            device_route_query_step(q, distributed.global_mesh(1), rows_per_shard=256)
            feed = stock_feed(**ARGS["stock"])
            send_feed(rt, "StockStream", feed[:2])
            rev = rt.persist()
            blob = store.load(rt.name, rev)
            m.shutdown()
            return rt.name, rev, blob, c.rows
        if name == "peer_death":
            m, rt, c = build(ARGS["peer_app"], "OutStream")
            fault = make_collector(siddhi_tpu_torch.StreamCallback)
            rt.add_callback("!StockStream", fault)
            q = rt.query_runtimes["bench"]
            device_route_query_step(q, distributed.global_mesh(1), rows_per_shard=256)
            rt.app_context.cluster_step_timeout = 4.0
            feed = stock_feed(**ARGS["stock"])
            send_feed(rt, "StockStream", feed[:2])
            if rank == 1:
                os._exit(0)         # abruptly: no shutdown, no goodbye
            t0 = time.time()
            send_feed(rt, "StockStream", feed[2:3])
            return len(c.rows), [str(d[-1]) for _t, d, _x in fault.rows], time.time() - t0

    for name in checks.split(","):
        res[name] = run(name)
    bad = [k for k in sys.modules if k in ("jax", "siddhi_tpu")
           or k.startswith(("jax.", "siddhi_tpu."))]
    assert not bad, bad
    res["imports_clean"] = True
    with open(out, "wb") as f:
        pickle.dump(res, f)
    os._exit(0)     # the group may hold a dead peer: no teardown to wait on
''')

STOCK = dict(seed=1, n_batches=4, batch=256, n_symbols=100, n_events=8)
SIDE = dict(seed=2, n_batches=3, batch=256, n_symbols=13, n_sides=5, n_events=16)
# the peer-death app routes its stream's errors to the '!StockStream' fault stream
PEER_APP = PARTITIONED_APP.format(W=8).replace(
    "define stream StockStream", "@OnError(action='stream')\ndefine stream StockStream", 1)
ARGS = {"flagship": FLAGSHIP, "pattern": PATTERN, "distinct": DISTINCT, "join": JOIN,
        "stock": STOCK, "side": SIDE, "persist_app": PERSIST_APP, "peer_app": PEER_APP}

GROUPS = {
    "two": (2, "flagship,flagship_generic,partitioned,pattern,routed_2,lut,"
               "distinct,join,persist"),
    "four": (4, "routed_1"),
    "peer": (2, "peer_death"),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Group:
    """One spawned gloo group running ``checks`` in every process."""

    def __init__(self, tmp: Path, name: str):
        P, checks = GROUPS[name]
        port = _free_port()
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        self.outs = [tmp / f"{name}{r}.pkl" for r in range(P)]
        self.logs = [open(tmp / f"{name}{r}.log", "w+") for r in range(P)]
        blob = pickle.dumps(ARGS).hex()
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(ROOT), str(port), str(P), str(r),
             str(self.outs[r]), checks, blob],
            stdout=self.logs[r], stderr=subprocess.STDOUT, env=env, cwd=str(tmp))
            for r in range(P)]
        self._res = None

    def results(self, ranks=None):
        if self._res is None:
            for p in self.procs:
                try:
                    p.wait(timeout=240)
                except subprocess.TimeoutExpired:
                    p.kill()
            self._res = {}
            for r, (out, log) in enumerate(zip(self.outs, self.logs)):
                log.seek(0)
                self._res[r] = (pickle.loads(out.read_bytes()) if out.exists()
                                else log.read()[-3000:])
        res = self._res if ranks is None else {r: self._res[r] for r in ranks}
        for r, v in res.items():
            assert isinstance(v, dict), f"process {r} failed:\n{v}"
        return res


class _Groups(dict):
    """The groups of this module's worker, each started at its first use
    (a worker that runs one test of the module spawns only its group)."""

    def __init__(self, tmp: Path):
        super().__init__()
        self.tmp = tmp

    def __missing__(self, name):
        g = self[name] = _Group(self.tmp, name)
        return g


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = _Groups(tmp_path_factory.mktemp("gloo"))
    yield started
    for g in started.values():
        for p in g.procs:
            if p.poll() is None:
                p.kill()
        for log in g.logs:
            log.close()


def _ref_rows(app, out, drive, fused=True):
    """The reference's single-process run of ``drive(rt)``."""
    import siddhi_tpu
    from siddhi_tpu.core import context
    from torch_helpers import fusion, make_collector

    with fusion(context, fused):
        m = siddhi_tpu.SiddhiManager()
        rt = m.create_siddhi_app_runtime(app)
    c = make_collector(siddhi_tpu.StreamCallback)
    rt.add_callback(out, c)
    drive(rt)
    m.shutdown()
    return c.rows


def _untimed(rows):
    return [(0, d, x) for _t, d, x in rows]


def _feeds():
    ns = {}
    exec(FEEDS, ns)
    return ns


def _stock_run(rt):
    from torch_helpers import send_feed

    send_feed(rt, "StockStream", stock_feed(**STOCK))


def test_children_import_neither_jax_nor_the_reference(groups):
    for name in GROUPS:
        groups[name]           # every group starts now, side by side
    for name in GROUPS:
        ranks = [0] if name == "peer" else None
        for r, res in groups[name].results(ranks).items():
            assert res["imports_clean"], (name, r)
            assert res["info"]["process_count"] == GROUPS[name][0]
            assert res["info"]["process_index"] == r


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_sharded_flagship_at_two_processes_equals_the_reference(groups, fused):
    """The flagship of ``tests/test_multihost.py:199``: fused, its state is
    the window's ring alone, whole on each process; generic, its selector
    state shards by group key behind the global window (split at the
    selector)."""
    feeds = _feeds()
    want = _ref_rows(FLAGSHIP, "Out", lambda rt: feeds["flagship_sends"](
        rt.get_input_handler("S")), fused=fused)
    key = "flagship" if fused else "flagship_generic"
    for r, res in groups["two"].results().items():
        split, rows = res[key]
        assert split == (None if fused else "select"), r
        assert len(rows) == 96
        assert_rows_match(rows, want)


def test_sharded_partitioned_queries_at_two_processes_equal_the_reference(groups):
    """The partitioned flagship (its keyed ring and selector split at the
    input) and the partitioned pattern of ``tests/test_multihost.py``
    (``[K, S]`` match slots split by owner, matches merged in the
    pattern's emission order)."""
    feeds = _feeds()
    want_p = _ref_rows(PARTITIONED_APP.format(W=8), "OutStream", _stock_run)
    want_n = _ref_rows(PATTERN, "Out", lambda rt: feeds["pattern_sends"](
        rt.get_input_handler("A"), rt.get_input_handler("B")))
    assert want_n
    for r, res in groups["two"].results().items():
        split, rows = res["partitioned"]
        assert split == "input" and len(rows) == 4 * 256 + 8
        assert_rows_match(rows, want_p)
        split, rows = res["pattern"]
        assert split == "input"
        assert_rows_match(rows, want_n)


def test_routed_flagship_across_processes_equals_the_reference_unrouted(groups):
    """The routed flagship at 2 processes x 2 shards and 4 x 1 (100
    symbols grow the routed capacity mid-feed), and the distinct group
    key through the LUT at 2 x 2."""
    want = _ref_rows(PARTITIONED_APP.format(W=8), "OutStream", _stock_run)
    for r, res in groups["two"].results().items():
        assert res["routed_2"][0] == (4, 2)
        assert_rows_match(res["routed_2"][1], want)
    for r, res in groups["four"].results().items():
        assert res["routed_1"][0] == (4, 1)
        assert_rows_match(res["routed_1"][1], want)
    from torch_helpers import send_feed

    want_lut = _ref_rows(DISTINCT_GK_APP, "Out",
                         lambda rt: send_feed(rt, "S", side_feed(**SIDE)))
    for r, res in groups["two"].results().items():
        assert res["lut"][0] is True
        assert_rows_match(res["lut"][1], want_lut)


def test_routed_distinct_and_join_at_two_processes_equal_the_reference(groups):
    """Distinct value tables ``[K, H]`` shard by key at 2 x 2 (each shard's
    scan on its local group ids); the partitioned keyed-length join at
    2 x 1, each side's routed step probing its own keys' rings."""
    from torch_helpers import send_feed

    feeds = _feeds()
    want_d = _ref_rows(DISTINCT, "Out",
                       lambda rt: send_feed(rt, "S", feeds["page_feed"](5, 3, 96)))
    want_j = _ref_rows(JOIN, "Out", lambda rt: feeds["join_sends"](rt, 0, 200))
    assert want_j
    for r, res in groups["two"].results().items():
        n, rows = res["distinct"]
        assert n == 4 and len(rows) == 3 * 96
        assert_rows_match(rows, want_d)
        n, rows = res["join"]
        assert n == 2
        # the join's sends take the wall clock: compare data and order
        assert_rows_match(_untimed(rows), _untimed(want_j))


def test_revision_persisted_at_two_processes_restores_at_one_by_four(groups):
    """The routed flagship persisted after half its feed at 2 processes:
    the revision is whole on both (one gather of every process's shards
    into the canonical layout); it restores into this process's routed
    1 x 4 runtime, into an unrouted runtime and into the reference, and
    the rows that follow equal the uninterrupted run's."""
    import siddhi_tpu
    from siddhi_tpu.core.util.persistence import InMemoryPersistenceStore as RefStore
    from torch_helpers import send_feed

    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    res = groups["two"].results()
    name, rev, blob, head = res[0]["persist"]
    assert res[1]["persist"][2] == blob
    feed = stock_feed(**STOCK)
    want = _ref_rows(PERSIST_APP, "OutStream", _stock_run)
    assert_rows_match(head, want[:len(head)])

    store = InMemoryPersistenceStore()
    store.save(name, rev, blob)
    port = Run("torch", PERSIST_APP, "OutStream", "bench")
    port.manager.set_persistence_store(store)
    device_route_query_step(port.query, make_mesh(4), rows_per_shard=256)
    port.rt.restore_revision(rev)
    tail = port.feed("StockStream", feed[2:]).close()
    assert_rows_match(head + tail, want)
    # into an unrouted runtime of the port
    plain = Run("torch", PERSIST_APP, "OutStream", "bench")
    plain.manager.set_persistence_store(store)
    plain.rt.restore_revision(rev)
    assert plain.query._route_layout is None
    assert_rows_match(head + plain.feed("StockStream", feed[2:]).close(), want)

    rstore = RefStore()
    rstore.save(name, rev, blob)
    m = siddhi_tpu.SiddhiManager()
    m.set_persistence_store(rstore)
    rt = m.create_siddhi_app_runtime(PERSIST_APP)
    from torch_helpers import make_collector

    c = make_collector(siddhi_tpu.StreamCallback)
    rt.add_callback("OutStream", c)
    rt.restore_revision(rev)
    send_feed(rt, "StockStream", feed[2:])
    m.shutdown()
    assert_rows_match(head + c.rows, want)


def test_peer_death_gives_a_labeled_fault_event_within_a_minute(groups):
    """Process 1 exits abruptly after two batches; process 0's next step
    fails its exchange with ``ClusterPeerError``, which ``@OnError(action=
    'stream')`` publishes on ``!StockStream`` naming the peer, within
    60 s."""
    (res,) = groups["peer"].results([0]).values()
    n_rows, faults, elapsed = res["peer_death"]
    assert n_rows == 2 * 256
    assert faults and len(faults) == 256
    assert "peer" in faults[0] and "presumed dead" in faults[0], faults[0]
    assert elapsed < 60.0
