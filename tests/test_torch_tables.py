"""Tables, named windows, on-demand queries and triggers on the port
(``core/table/``, ``core/query/output_callbacks.py``,
``core/window/named_window.py``, ``core/query/on_demand.py``,
``core/trigger/trigger.py``) against the reference, on the CPU.

Seeded two-stream feeds (``torch_helpers.two_stream_feed``) go through
both packages for stream-table joins on a ``@primaryKey`` (the indexed
probe), on an ``@index`` with a residual condition and on a broadcast
condition; every table action (``insert into``, ``delete``, ``update``,
``update or insert into``); ``in <table>``; a named window as a join side
and as a query's source; on-demand finds and mutations after the feed;
an ``every`` trigger under ``@app:playback``; and the state of a join and
of a table carried from the reference into the port mid-feed
(``interop.load_reference_state``). Rows must be equal: ints, strings,
timestamps, types and order exactly, floats to rtol 1e-12.
"""

import jax
import numpy as np
import pytest

from siddhi_tpu_torch.interop import load_reference_state
from torch_helpers import (  # release_jax_programs: an autouse fixture
    Run, assert_multi_match, assert_rows_match, release_jax_programs,
    send_multi, two_stream_feed)

HEAD = """@app:playback
define stream A (k string, v double);
define stream B (k string, v double);
"""

SHAPES = {
    "pk_join": """
        @primaryKey('k') define table T (k string, v double);
        from B select k, v update or insert into T on T.k == k;
        @info(name='q') from A join T on A.k == T.k
        select A.k as k, A.v as av, T.v as tv insert into O;""",
    "index_join_residual": """
        @index('k') define table T (k string, v double);
        from B insert into T;
        @info(name='q') from A join T on T.k == A.k and T.v < A.v
        select A.k as k, A.v as av, T.v as tv insert into O;""",
    "broadcast_join": """
        define table T (k string, v double);
        from B insert into T;
        @info(name='q') from A#window.length(3) join T on A.v > T.v
        select A.k as k, T.k as tk, T.v as tv insert into O;""",
    "actions": """
        define table T (k string, v double);
        from B[v >= 5.0] insert into T;
        from B[v < 2.0] delete T on T.k == k;
        from A[v > 5.0] update T set T.v = v on T.k == k;
        from A[v <= 5.0] select k, v update or insert into T on T.k == k and T.v < v;
        @info(name='q') from A join T on A.k == T.k
        select A.k as k, A.v as av, T.v as tv insert into O;""",
    "in_table": """
        define table T (k string, v double);
        from B insert into T;
        from B[v > 8.0] delete T on T.k == k;
        @info(name='q') from A[(k == T.k and v > T.v) in T]
        select k, v insert into O;""",
    "named_window_join": """
        define window W (k string, v double) length(5) output all events;
        from B insert into W;
        @info(name='q') from A#window.length(6) join W on A.k == W.k
        select A.k as k, A.v as av, W.v as wv insert into O;""",
    "named_window_source": """
        define window W (k string, v double) time(1 sec);
        from A insert into W;
        @info(name='q') from W select k, sum(v) as s group by k
        insert all events into O;""",
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_table_and_window_shapes_match_reference(shape):
    feed = two_stream_feed(11 + len(shape), n_items=36)
    assert assert_multi_match(HEAD + SHAPES[shape], feed) > 0


def test_indexed_probes_engage_on_the_port():
    r = Run("torch", HEAD + SHAPES["pk_join"], "O", "q")
    assert r.query.index_probe["attr"] == "k" and r.query.engine is None
    r.close()
    r = Run("torch", HEAD + SHAPES["index_join_residual"], "O", "q")
    assert r.query.index_probe["residual_fn"] is not None
    r.close()


ON_DEMAND_APP = HEAD + """
@primaryKey('k') define table T (k string, v double);
@index('v') define table U (k string, v double);
define window W (k string, v double) length(4);
from B select k, v update or insert into T on T.k == k;
from A insert into U;
from A insert into W;
@info(name='q') from A select k, v insert into O;
"""

ON_DEMAND = [
    "from T select k, v",
    "from T on k == 'K1' select k, v",
    "from U on v > 3.0 select k, v order by v desc limit 3",
    "from U on k == 'K2' or v < 1.0 select k, v",
    "from W select k, v",
    "select 'K9', 1.5 insert into T",
    "select 'K1' as key delete T on T.k == key",
    "select 7.25 as nv update T set T.v = nv on T.k == 'K2'",
    "select 'K3' as kk, 2.5 as nv update or insert into T set T.v = nv on T.k == kk",
    "from T select k, v order by k",
]


def test_on_demand_queries_match_reference():
    feed = two_stream_feed(23, n_items=30)
    got = {}
    for pkg in ("jax", "torch"):
        r = Run(pkg, ON_DEMAND_APP, "O", "q")
        send_multi(r.rt, feed)
        got[pkg] = [[(0, tuple(e.data), False) for e in r.rt.query(q)]
                    for q in ON_DEMAND]
        r.close()
    for a, b in zip(got["torch"], got["jax"]):
        assert_rows_match(a, b)
    assert any(got["jax"])


def test_every_trigger_under_playback_matches_reference():
    app = HEAD + """
        define trigger Tick at every 700 millisec;
        @info(name='q') from Tick select triggered_time as t insert into O;
        from A select k insert into Sink;"""
    feed = two_stream_feed(29, streams=("A",), n_items=20)
    assert assert_multi_match(app, feed) > 3


def _reference_tree(q):
    from siddhi_tpu.core.join import ENGINE_STATE_KEYS

    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(q._state))
    return {k: v for k, v in tree.items() if k not in ENGINE_STATE_KEYS}


@pytest.mark.parametrize("config", [None, {"siddhi_tpu.join_partitions": "4"}],
                         ids=["auto", "engine_p4"])
def test_join_and_table_state_carried_from_reference(config):
    """The reference runs the first half of the feed; its join state (the
    engine's derived keys stripped) and its table's rows go into a fresh
    port app, the second half goes to both, and the port's rows equal the
    reference's."""
    app = HEAD + """
        define table T (k string, v double);
        from B[v > 4.0] insert into T;
        @info(name='q') from A#window.length(24) join B#window.length(20)
        on A.k == B.k select A.k as k, A.v as av, B.v as bv insert into O;
        @info(name='t') from A join T on A.k == T.k
        select A.k as k, A.v as av, T.v as bv insert into O;"""
    feed = two_stream_feed(37, n_items=40)
    first, second = feed[:20], feed[20:]
    ref = Run("jax", app, "O", "q")
    send_multi(ref.rt, first)
    port = Run("torch", app, "O", "q", config=config)
    strings = list(ref.rt.app_context.string_dictionary._to_str)
    load_reference_state(port.query, _reference_tree(ref.query), strings)
    table = ref.rt.tables["T"]
    load_reference_state(port.rt.tables["T"],
                         {"cols": {k: np.asarray(v) for k, v in table.state["cols"].items()},
                          "valid": np.asarray(table.state["valid"])}, strings)
    # the playback clock stands where the reference's does
    port.rt.app_context.timestamp_generator.set_current_timestamp(
        ref.rt.app_context.timestamp_generator.current_time())
    n_first = len(ref.collector.rows)
    send_multi(ref.rt, second)
    want = ref.close()[n_first:]
    send_multi(port.rt, second)
    got = port.close()
    assert want
    assert_rows_match(got, want)


def test_update_or_insert_into_a_store_table():
    """`update or insert into` a ``@store`` table updates the matching
    row and inserts an unmatched event (the reference's adapter has no
    ``update_or_insert``: it logs an AttributeError and drops the events,
    ROADMAP C, R5)."""
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime("""
        define stream S (k string, v long);
        @store(type='inMemory') @primaryKey('k') define table T (k string, v long);
        from S select k, v update or insert into T on T.k == k;""")
    h = rt.get_input_handler("S")
    for row in (["a", 1], ["b", 2], ["a", 3]):
        h.send(row)
    assert sorted(e.data for e in rt.query("from T select k, v")) == [["a", 3], ["b", 2]]
    m.shutdown()


@pytest.mark.parametrize("chunk", [0, 3, 4096], ids=["walk", "chunk3", "default"])
def test_update_or_insert_chunks_match_reference(chunk, monkeypatch):
    """The unmatched events of an ``update or insert`` insert a chunk at a
    time where no event of the chunk matches a row, and walk one at a time
    where one does (a later event updating a row an earlier one inserted):
    every chunk size, 0 walking every event, gives the reference's table
    and join rows."""
    from siddhi_tpu_torch.core.table.in_memory_table import InMemoryTable

    monkeypatch.setattr(InMemoryTable, "insert_chunk", chunk)
    app = HEAD + """
        define table T (k string, v double);
        from B select k, v update or insert into T on T.k == k and T.v < v;
        @info(name='q') from A join T on A.k == T.k
        select A.k as k, A.v as av, T.v as tv insert into O;"""
    feed = two_stream_feed(43, n_items=36, n_keys=12)
    tables, rows = {}, {}
    for pkg in ("jax", "torch"):
        r = Run(pkg, app, "O", "q")
        send_multi(r.rt, feed)
        tables[pkg] = [(0, tuple(e.data), False) for e in r.rt.query("from T select k, v")]
        rows[pkg] = r.close()
    assert len(tables["jax"]) > 12 and rows["jax"]
    assert_rows_match(tables["torch"], tables["jax"])
    assert_rows_match(rows["torch"], rows["jax"])
