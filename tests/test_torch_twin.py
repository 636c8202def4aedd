"""The generic window -> aggregator path through both packages' public
API: the entry point's twin of the flagship (``__graft_entry__._APP``), the
reference's min/max behaviour over a sliding window (ROADMAP queue C, R2),
the other aggregators on the generic path, and ``order by`` / ``limit`` /
``offset`` on string and numeric keys. Tolerance: torch_helpers (floats
rtol 1e-12, everything else exact)."""

import numpy as np
import pytest
from torch_helpers import Run, assert_rows_match, send_feed

from siddhi_tpu_torch.ops.windows import LengthWindowStage

# a copy of __graft_entry__._APP: min() keeps it off the fused stage
TWIN_APP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'flagship')
from StockStream[price > 0.0]#window.length(128)
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume, count() as n,
       min(price) as minPrice
group by symbol
insert into OutStream;
"""


def _twin_feed(seed, n_batches, batch, n_symbols, n_events):
    """StockStream batches whose prices are U(-20, 100): about a sixth of
    the rows fail the twin's ``price > 0.0`` filter."""
    rng = np.random.default_rng(seed)
    syms = np.array([f"S{i}" for i in range(n_symbols)], dtype=object)
    feed, ts = [], 0
    for _ in range(n_batches):
        cols = {"symbol": syms[rng.integers(0, n_symbols, batch)],
                "price": (rng.random(batch) * 120.0 - 20.0).astype(np.float32),
                "volume": rng.integers(1, 1000, batch)}
        feed.append(("cols", cols, np.arange(ts, ts + batch, dtype=np.int64)))
        ts += batch
    for i in range(n_events):
        feed.append(("event", ts + i, [str(syms[rng.integers(0, n_symbols)]),
                                       float(rng.random() * 120.0 - 20.0),
                                       int(rng.integers(1, 1000))]))
    return feed


def test_twin_matches_jax():
    feed = _twin_feed(seed=31, n_batches=3, batch=256, n_symbols=64, n_events=8)
    want = Run("jax", TWIN_APP, "OutStream", "flagship").feed(
        "StockStream", feed).close()
    port = Run("torch", TWIN_APP, "OutStream", "flagship")
    assert type(port.query.window_stage) is LengthWindowStage
    got = port.feed("StockStream", feed).close()
    positive = sum(int((f[1]["price"] > 0).sum()) if f[0] == "cols"
                   else int(f[2][1] > 0) for f in feed)
    assert len(want) == positive < 3 * 256 + 8
    assert_rows_match(got, want)


def test_min_max_keep_evicted_values_as_the_reference_does():
    """R2: the reference folds EXPIRED rows into min/max as the identity,
    so an evicted extreme is never dropped. Window semantics would give
    min 1, 1, 5, 3; the reference gives 1, 1, 1, 1, and so does the port."""
    app = ("define stream S (v int);\n@info(name = 'q')\n"
           "from S#window.length(2) select min(v) as mn, max(v) as mx "
           "insert into O;")
    feed = [("event", i, [v]) for i, v in enumerate([1, 5, 7, 3])]
    want = Run("jax", app, "O", "q").feed("S", feed).close()
    got = Run("torch", app, "O", "q").feed("S", feed).close()
    assert [r[1] for r in got] == [(1, 1), (1, 5), (1, 7), (1, 7)]
    assert_rows_match(got, want)


def test_other_aggregators_on_the_generic_path_match_jax():
    app = """
    define stream S (symbol string, v double, n int, b bool);
    @info(name = 'q')
    from S#window.length(6)
    select symbol, stdDev(n) as sd, and(b) as allb, or(b) as anyb,
           maxForever(v) as mxf, minForever(n) as mnf, max(v) as mx, sum(n) as t
    group by symbol
    insert into O;
    """
    rng = np.random.default_rng(5)
    syms = np.array(["a", "b", "c"], dtype=object)
    feed = [("cols", {"symbol": syms[rng.integers(0, 3, 24)],
                      "v": rng.standard_normal(24), "n": rng.integers(-9, 9, 24),
                      "b": rng.random(24) < 0.7},
             np.arange(s * 24, (s + 1) * 24, dtype=np.int64)) for s in range(2)]
    feed += [("event", 100 + i, ["a", None if i % 2 else 1.5, i, i % 3 > 0])
             for i in range(5)]
    want = Run("jax", app, "O", "q").feed("S", feed).close()
    got = Run("torch", app, "O", "q").feed("S", feed).close()
    assert len(want) == 2 * 24 + 5
    assert_rows_match(got, want)


ORDER_APPS = {
    "string_desc_then_number": (
        "from S select symbol, price order by symbol desc, price "
        "limit 7 offset 2 insert into O;"),
    "number_only_limit": "from S select symbol, price order by price limit 3 "
                         "insert into O;",
    "offset_only": "from S select symbol, price offset 5 insert into O;",
    "aggregate_key": (
        "from S#window.length(10) select symbol, sum(price) as t "
        "group by symbol order by t desc, symbol limit 4 insert into O;"),
}


@pytest.mark.parametrize("query", list(ORDER_APPS), ids=list(ORDER_APPS))
def test_order_by_limit_offset_match_jax(query):
    """Strings arrive out of lexicographic order (ids follow arrival), so a
    string key must sort by the dictionary's rank table, not by id; nulls
    sort after every string."""
    app = ("define stream S (symbol string, price double);\n"
           "@info(name = 'q')\n" + ORDER_APPS[query])
    rng = np.random.default_rng(9)
    syms = np.array(["kiwi", "apple", "fig", "banana", None, "cherry"], dtype=object)
    feed = [("cols", {"symbol": syms[rng.integers(0, 6, 16)],
                      "price": np.round(rng.random(16) * 8, 1)},
             np.arange(s * 16, (s + 1) * 16, dtype=np.int64)) for s in range(3)]
    feed.append(("event", 99, ["date", 1.0]))
    want = Run("jax", app, "O", "q").feed("S", feed).close()
    port = Run("torch", app, "O", "q")
    got = port.feed("S", feed).close()
    assert len(want) > 0
    assert_rows_match(got, want)


def test_order_by_is_not_routed():
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.ops.expressions import CompileError
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(
        "define stream S (symbol string, price double);\n@info(name = 'q')\n"
        "from S select symbol, sum(price) as t group by symbol order by t "
        "insert into O;")
    with pytest.raises(CompileError, match="order by"):
        device_route_query_step(rt.query_runtimes["q"], make_mesh(2))


def test_send_feed_of_singles_keeps_the_lazy_rank_table_fresh():
    """The rank table grows with the dictionary between batches."""
    app = ("define stream S (symbol string, price double);\n@info(name = 'q')\n"
           "from S#window.length(3) select symbol, count() as n group by symbol "
           "order by symbol insert into O;")
    feed = [("event", i, [s, 1.0]) for i, s in enumerate(["b", "a", "c", "a", "0"])]
    want = Run("jax", app, "O", "q").feed("S", feed).close()
    port = Run("torch", app, "O", "q")
    send_feed(port.rt, "S", feed)
    assert_rows_match(port.close(), want)
