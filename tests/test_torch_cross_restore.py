"""Snapshots across packages (``core/util/snapshot.py``), on the CPU.

The same app runs in the JAX package (the reference) and the port. A
snapshot taken by one after the head of a seeded feed restores into a
fresh runtime of the other, which runs the tail; head + tail equal the
reference's uninterrupted run (ints, strings and order exact, floats to
rtol 1e-12), in both directions. App shapes: a fused grouped window, a
distinct aggregator, a pattern (with its high-water marks), an engine
join, a table with its insert journal (a full revision and an incremental
one, restored as a chain), a purged partition, a host window and an
incremental aggregation (its find and its join).

Also: the port's snapshots name no global outside builtins and numpy
(a ``pickletools.genops`` scan), and the restricted unpickler refuses a
pickle that names a class of ``siddhi_tpu`` without importing it.
"""

import pickle
import pickletools
import subprocess
import sys

import numpy as np
import pytest

from torch_helpers import (
    assert_rows_match, make_collector, release_jax_programs, send_multi)  # noqa: F401

DIRECTIONS = [("jax", "torch"), ("torch", "jax")]


def _pkg(pkg):
    if pkg == "jax":
        import siddhi_tpu
        from siddhi_tpu.core.util.config import InMemoryConfigManager
        from siddhi_tpu.core.util.persistence import InMemoryPersistenceStore

        return siddhi_tpu, siddhi_tpu.SiddhiManager, InMemoryConfigManager, InMemoryPersistenceStore
    import functools

    import siddhi_tpu_torch
    from siddhi_tpu_torch import InMemoryConfigManager
    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore

    return (siddhi_tpu_torch,
            functools.partial(siddhi_tpu_torch.SiddhiManager, device="cpu"),
            InMemoryConfigManager, InMemoryPersistenceStore)


def _build(pkg, shape, store=None):
    mod, manager, cfg, _store = _pkg(pkg)
    m = manager()
    if shape.get("config"):
        m.set_config_manager(cfg(dict(shape["config"])))
    if store is not None:
        m.set_persistence_store(store)
    rt = m.create_siddhi_app_runtime(shape["app"])
    c = make_collector(mod.StreamCallback)
    rt.add_callback("O", c)
    return m, rt, c


def _finish(rt, shape):
    """Rows a shape reads back after its feed besides the stream's (a
    table's contents, an aggregation's find)."""
    q = shape.get("read")
    if q is None:
        return []
    return [(0, tuple(e.data), False) for e in rt.query(q)]


def _stock_feed(seed, n, streams=("S",), n_sym=5, t0=1_000, gaps=(0, 1, 40, 300, 1200)):
    rng = np.random.default_rng(seed)
    out, t = [], t0
    for _ in range(n):
        t += int(rng.choice(gaps))
        s = streams[int(rng.integers(0, len(streams)))]
        sym = f"K{int(rng.integers(0, n_sym))}"
        if s == "Q":
            out.append((s, t, [sym]))
        elif s in ("A", "B"):
            out.append((s, t, [sym, float(np.round(rng.random() * 10, 1))]))
        elif s in ("L", "R"):
            out.append((s, t, [sym, int(rng.integers(0, 50))]))
        else:
            out.append((s, t, [sym, float(np.round(rng.random() * 100, 2)),
                               int(rng.integers(1, 20))]))
    return out


STOCK = "define stream S (symbol string, price double, volume long);\n"

SHAPES = {
    "fused_grouped_window": dict(app="@app:name('xfused') @app:playback " + STOCK + """
        @info(name='q') from S#window.length(6)
        select symbol, avg(price) as ap, sum(volume) as tv group by symbol
        insert into O;""", feed=_stock_feed(1, 60)),
    "distinct_aggregator": dict(app="@app:name('xdistinct') @app:playback " + STOCK + """
        @info(name='q') from S#window.length(6)
        select symbol, distinctCount(volume) as dc group by symbol
        insert into O;""", feed=_stock_feed(2, 60)),
    "pattern_high_water_marks": dict(app="""@app:name('xnfa') @app:playback
        define stream A (k string, v double);
        define stream B (k string, v double);
        @info(name='q') from every e1=A -> e2=B[e2.k == e1.k and e2.v > e1.v] within 2 sec
        select e1.k as k, e1.v as v1, e2.v as v2 insert into O;""",
        feed=_stock_feed(3, 60, streams=("A", "B"))),
    "engine_join": dict(app="""@app:name('xjoin') @app:playback
        define stream L (sym string, lv long);
        define stream R (sym string, rv long);
        @info(name='q') from L#window.length(16) join R#window.length(16)
          on L.sym == R.sym
          select L.sym as sym, L.lv as lv, R.rv as rv insert into O;""",
        feed=_stock_feed(4, 60, streams=("L", "R")),
        config={"siddhi_tpu.join_engine": "device", "siddhi_tpu.join_partitions": "4"}),
    "table_journal_chain": dict(app="""@app:name('xtable') @app:playback
        define stream S (symbol string, price double, volume long);
        define stream Q (symbol string);
        define table T (symbol string, price double, volume long);
        from S insert into T;
        @info(name='q') from Q join T on Q.symbol == T.symbol
        select Q.symbol as symbol, T.price as price, T.volume as volume insert into O;""",
        feed=_stock_feed(5, 60, streams=("S", "S", "Q")), chain=True,
        read="from T select symbol, price, volume"),
    "purged_partition": dict(app="@app:name('xpurge') @app:playback " + STOCK + """
        @purge(enable='true', interval='1 hour', idle.period='1 hour')
        partition with (symbol of S)
        begin
          @info(name='q') from S#window.length(4)
          select symbol, sum(volume) as tv insert into O;
        end;""", feed=_stock_feed(6, 60, n_sym=8), purge=True),
    "host_window": dict(app="@app:name('xhost') @app:playback " + STOCK + """
        @info(name='q') from S#window.sort(4, price)
        select symbol, price insert all events into O;""", feed=_stock_feed(7, 60)),
    "aggregation": dict(app="@app:name('xagg') @app:playback " + STOCK + """
        define stream Q (symbol string);
        define aggregation A from S
        select symbol, avg(price) as ap, sum(volume) as tv, count() as n,
               min(price) as lo, max(price) as hi
        group by symbol aggregate every sec ... day;
        @info(name='q') from Q join A on Q.symbol == A.symbol
          within 0L, 100000000L per 'seconds'
        select Q.symbol as symbol, A.AGG_TIMESTAMP as t, A.ap as ap, A.tv as tv
        insert into O;""", feed=_stock_feed(8, 80, streams=("S", "S", "S", "Q")),
        read="from A within 0L, 100000000L per 'minutes' "
             "select symbol, ap, tv, n, lo, hi order by symbol"),
}


def _purge_old_keys(rt):
    """Retire the partition's first two keys, as an idle sweep would
    (``tests/test_partition_purge.py``): their ids go to the free list,
    which the snapshot must carry."""
    pctx = rt.partition_contexts[0]
    ks = pctx.keyspace
    for kid in sorted(ks.last_seen)[:2]:
        ks.last_seen[kid] = 0
    pctx.purge()


def _straight(pkg, shape):
    m, rt, c = _build(pkg, shape)
    feed = shape["feed"]
    half = len(feed) // 2
    send_multi(rt, feed[:half])
    if shape.get("purge"):
        _purge_old_keys(rt)
    send_multi(rt, feed[half:])
    rows = list(c.rows) + _finish(rt, shape)
    m.shutdown()
    return rows


def _split(src, dst, shape):
    """Head in ``src``, snapshot (or a full + incremental revision chain),
    restore into a fresh ``dst`` runtime, tail there. Returns (rows, the
    snapshot bytes the source produced)."""
    feed = shape["feed"]
    half = len(feed) // 2
    if shape.get("chain"):
        sstore = _pkg(src)[3]()
        m1, rt1, c1 = _build(src, shape, store=sstore)
        send_multi(rt1, feed[:half // 2])
        r0 = rt1.persist()
        send_multi(rt1, feed[half // 2:half])
        rev = rt1.persist_incremental()
        blobs = [sstore.load(rt1.name, r) for r in (r0, rev)]
        assert pickle.loads(blobs[1]).get("incremental")
        name = rt1.name
    else:
        m1, rt1, c1 = _build(src, shape)
        send_multi(rt1, feed[:half])
        if shape.get("purge"):
            _purge_old_keys(rt1)
        blobs = [rt1.snapshot()]
    head = list(c1.rows)
    m1.shutdown()
    if shape.get("chain"):
        dstore = _pkg(dst)[3]()
        dstore.save(name, r0, blobs[0])
        dstore.save(name, rev, blobs[1])
        m2, rt2, c2 = _build(dst, shape, store=dstore)
        rt2.restore_revision(rev)
    else:
        m2, rt2, c2 = _build(dst, shape)
        rt2.restore(blobs[0])
    send_multi(rt2, feed[half:])
    rows = head + list(c2.rows) + _finish(rt2, shape)
    m2.shutdown()
    return rows, blobs


_WANT = {}


def _want(shape):
    """The reference's uninterrupted run of a shape (once per module), held
    equal to the port's."""
    if shape not in _WANT:
        want = _straight("jax", SHAPES[shape])
        assert_rows_match(_straight("torch", SHAPES[shape]), want)
        _WANT[shape] = want
    return _WANT[shape]


@pytest.mark.parametrize("src,dst", DIRECTIONS, ids=lambda p: p)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cross_package_restore_continues_the_same_run(shape, src, dst):
    sh = SHAPES[shape]
    want = _want(shape)
    got, blobs = _split(src, dst, sh)
    assert_rows_match(got, want)
    assert len(want) > 4, shape
    if src == "torch":
        for blob in blobs:
            assert _globals(blob) - _ALLOWED == set(), shape


_ALLOWED = {("builtins", n) for n in (
    "set", "frozenset", "list", "dict", "tuple", "int", "float", "bool",
    "str", "bytes", "complex")} | {
    (m, n) for m in ("numpy.core.multiarray", "numpy._core.multiarray")
    for n in ("_reconstruct", "scalar")} | {
    (m, "_frombuffer") for m in ("numpy.core.numeric", "numpy._core.numeric")} | {
    ("numpy", "dtype"), ("numpy", "ndarray")}


def _globals(blob: bytes) -> set:
    """Every (module, name) a pickle's GLOBAL / STACK_GLOBAL / INST
    opcodes name (STACK_GLOBAL reads the two strings pushed before it,
    through the memo)."""
    found, strings, memo = set(), [], {}
    for op, arg, _pos in pickletools.genops(blob):
        name = op.name
        if name in ("GLOBAL", "INST"):
            found.add(tuple(arg.split(" ", 1)))
        elif name == "STACK_GLOBAL":
            found.add((strings[-2], strings[-1]))
        elif name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE", "BINUNICODE8"):
            strings.append(arg)
        elif name == "MEMOIZE":
            if strings:
                memo[len(memo)] = strings[-1]
        elif name in ("BINGET", "LONG_BINGET", "GET") and arg in memo:
            strings.append(memo[arg])
    return {g for g in found if not g[0].startswith("numpy.dtypes")}


def test_port_snapshot_of_every_state_kind_names_builtins_and_numpy_only():
    """One app with a routed partitioned query, a table, a named window,
    a pattern and an aggregation: its snapshot's globals."""
    import siddhi_tpu_torch
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime("@app:name('scan') @app:playback " + STOCK + """
        define stream A (k string, v double);
        define stream B (k string, v double);
        define table T (symbol string, price double, volume long);
        define window W (symbol string, price double) length(4);
        define aggregation G from S select symbol, sum(price) as s, distinctCount(volume) as d
          group by symbol aggregate every sec ... min;
        from S insert into T;
        from S select symbol, price insert into W;
        partition with (symbol of S)
        begin
          @info(name='r') from S#window.length(4)
          select symbol, avg(price) as ap, sum(volume) as tv insert into O;
        end;
        from every e1=A -> e2=B[e2.v > e1.v] within 2 sec
        select e1.k as k, e2.v as v insert into M;""")
    device_route_query_step(rt.query_runtimes["r"], make_mesh(2), rows_per_shard=64)
    send_multi(rt, _stock_feed(9, 40, streams=("S", "A", "B")))
    blob = rt.snapshot()
    m.shutdown()
    assert _globals(blob) - _ALLOWED == set()


def test_restricted_unpickler_refuses_a_foreign_class_without_importing_it():
    """A pickle naming ``siddhi_tpu.core.event.Event`` is refused by name,
    and loading it never imports ``siddhi_tpu`` (checked in a fresh
    interpreter)."""
    # protocol 2: GLOBAL 'siddhi_tpu.core.event Event', then NEWOBJ of ()
    blob = b"\x80\x02csiddhi_tpu.core.event\nEvent\n)\x81."
    code = (
        "import sys, pickle\n"
        "from siddhi_tpu_torch.core.util.snapshot import safe_loads\n"
        f"blob = {blob!r}\n"
        "try:\n"
        "    safe_loads(blob)\n"
        "except pickle.UnpicklingError as e:\n"
        "    assert 'siddhi_tpu.core.event.Event' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('loaded')\n"
        "assert not any(m == 'siddhi_tpu' or m.startswith('siddhi_tpu.')\n"
        "               for m in sys.modules), 'siddhi_tpu was imported'\n"
        "print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "refused" in out.stdout, out.stderr


def test_a_leaf_of_another_dtype_is_refused_not_cast():
    """A revision whose state leaf has another dtype than the runtime's
    (a float32 sum where the runtime keeps float64) raises naming the
    leaf; nothing is cast."""
    import siddhi_tpu_torch

    shape = SHAPES["fused_grouped_window"]
    m, rt, _c = _build("torch", shape)
    send_multi(rt, shape["feed"][:10])
    obj = pickle.loads(rt.snapshot())
    m.shutdown()
    state = obj["queries"]["q"]["state"]
    path, leaf = _first_float64_leaf(state)
    _set_leaf(state, path, leaf.astype(np.float32))
    m2 = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt2 = m2.create_siddhi_app_runtime(shape["app"])
    with pytest.raises(ValueError, match="/".join(map(str, path)) + ".*float32.*float64"):
        rt2.restore(pickle.dumps(obj))
    m2.shutdown()


def _first_float64_leaf(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            hit = _first_float64_leaf(v, path + (k,))
            if hit is not None:
                return hit
        return None
    return (path, tree) if np.asarray(tree).dtype == np.float64 else None


def _set_leaf(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value
