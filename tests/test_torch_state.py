"""State carried from the JAX package into the port: run the first half of
a feed in JAX, hand its state (canonical numpy layout), string dictionary
and partition key space to ``load_reference_state``, then feed the second
half to both. Their outputs must agree — unrouted, and routed at 4 shards
on both sides (the routed JAX state travels through
``canonical_route_state``)."""

import jax
import numpy as np
import pytest
from torch_helpers import (
    DISTINCT_GK_APP,
    PARTITIONED_APP,
    Run,
    assert_rows_match,
    send_feed,
    side_feed,
    stock_feed,
)

from siddhi_tpu_torch.interop import load_reference_state

APP_W8 = PARTITIONED_APP.format(W=8)


def _reference_state(run, routed):
    q = run.query
    if routed:
        from siddhi_tpu.parallel.mesh import canonical_route_state

        return canonical_route_state(q)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(q._state))


@pytest.mark.parametrize("app,stream,out,query", [
    (APP_W8, "StockStream", "OutStream", "bench"),
    (DISTINCT_GK_APP, "S", "Out", "q"),
], ids=["flagship", "distinct_gk"])
@pytest.mark.parametrize("routed", [None, 4], ids=["unrouted", "routed4"])
def test_state_carried_from_jax_continues_identically(app, stream, out, query,
                                                      routed):
    if stream == "StockStream":
        feed = stock_feed(seed=4, n_batches=4, batch=256, n_symbols=48,
                          n_events=8)
    else:
        feed = side_feed(seed=5, n_batches=4, batch=256, n_symbols=13,
                         n_sides=5)
    first, second = feed[:2], feed[2:]
    jax_run = Run("jax", app, out, query, routed_n=routed)
    send_feed(jax_run.rt, stream, first)
    tree = _reference_state(jax_run, routed)
    jq = jax_run.query
    group_keys = (None if jq.keyer is None
                  else {"map": dict(jq.keyer._map), "next": jq.keyer._next})

    port = Run("torch", app, out, query, routed_n=routed)
    load_reference_state(
        port.query, tree,
        dictionary_ids=list(jax_run.rt.app_context.string_dictionary._to_str),
        partition_keys=jax_run.rt.partition_contexts[0].keyspace.snapshot(),
        group_keys=group_keys)

    n_first = len(jax_run.collector.rows)
    jax_rows = jax_run.feed(stream, second).close()[n_first:]
    port_rows = port.feed(stream, second).close()
    assert len(port_rows) == sum(
        len(f[2]) if f[0] == "cols" else 1 for f in second)
    assert_rows_match(port_rows, jax_rows)
    if routed:
        assert port.query._route_layout.n == routed


GLOBAL_FLAGSHIP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'bench')
from StockStream#window.length(40)
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
group by symbol
insert into OutStream;
"""

# __graft_entry__._APP at a small window: the generic path
GLOBAL_TWIN = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'flagship')
from StockStream[price > 0.0]#window.length(40)
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume, count() as n,
       min(price) as minPrice
group by symbol
insert into OutStream;
"""


@pytest.mark.parametrize("app,query,stage", [
    (GLOBAL_FLAGSHIP, "bench", "FusedSlidingAggStage"),
    (GLOBAL_TWIN, "flagship", "LengthWindowStage"),
], ids=["fused_flagship", "generic_twin"])
def test_global_state_carried_from_jax_continues_identically(app, query, stage):
    """Unpartitioned queries: the fused stage's ring (``s*_*``, ``rgk``,
    ``fill``, ``head``, empty ``sel``) and the unkeyed length window
    (``buf``, 0-d ``total``) install as they are, with the dictionary ids
    and group keys, and both packages continue the feed alike."""
    feed = stock_feed(seed=6, n_batches=4, batch=256, n_symbols=300, n_events=6)
    first, second = feed[:2], feed[2:]
    jax_run = Run("jax", app, "OutStream", query)
    send_feed(jax_run.rt, "StockStream", first)
    jq = jax_run.query
    tree = _reference_state(jax_run, None)
    port = Run("torch", app, "OutStream", query)
    assert type(port.query.window_stage).__name__ == stage
    load_reference_state(
        port.query, tree,
        dictionary_ids=list(jax_run.rt.app_context.string_dictionary._to_str),
        group_keys={"map": dict(jq.keyer._map), "next": jq.keyer._next})
    n_first = len(jax_run.collector.rows)
    jax_rows = jax_run.feed("StockStream", second).close()[n_first:]
    port_rows = port.feed("StockStream", second).close()
    assert len(port_rows) == len(jax_rows) > 2 * 256 // 2
    assert_rows_match(port_rows, jax_rows)


GLOBAL_DISTINCT = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'bench')
from StockStream#window.length(40)
select symbol, distinctCount(volume % 7) as vols,
       unionSet(createSet(volume % 5)) as vs, avg(price) as avgPrice
group by symbol
insert into OutStream;
"""


def test_distinct_state_carried_from_jax_continues_identically():
    """distinctCount/unionSet value tables (``{vk, vc, stamp, eb}`` per
    aggregator, nested in ``sel``) install beside the window's ring, and
    both packages continue the feed alike, sets included."""
    feed = stock_feed(seed=7, n_batches=4, batch=256, n_symbols=30, n_events=6)
    first, second = feed[:2], feed[2:]
    jax_run = Run("jax", GLOBAL_DISTINCT, "OutStream", "bench")
    send_feed(jax_run.rt, "StockStream", first)
    jq = jax_run.query
    tree = _reference_state(jax_run, None)
    assert set(tree["sel"]["a0"]) == {"vk", "vc", "stamp", "eb"}
    port = Run("torch", GLOBAL_DISTINCT, "OutStream", "bench")
    load_reference_state(
        port.query, tree,
        dictionary_ids=list(jax_run.rt.app_context.string_dictionary._to_str),
        group_keys={"map": dict(jq.keyer._map), "next": jq.keyer._next})
    assert port.query.selector_plan.num_keys == tree["sel"]["a0"]["vk"].shape[0]
    n_first = len(jax_run.collector.rows)
    jax_rows = jax_run.feed("StockStream", second).close()[n_first:]
    port_rows = port.feed("StockStream", second).close()
    assert len(port_rows) == len(jax_rows) == 2 * 256 + 6
    assert_rows_match(port_rows, jax_rows)
