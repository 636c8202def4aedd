"""Host windows inside ``partition with`` (one stage instance per key),
range partitions, inner ``#streams`` and partition-local streams in the
port against the JAX package, app by app under ``@app:playback`` on
``mixed_feed`` (single events, then column batches, with clock jumps that
fire timers between and inside sends). Stream rows and QueryCallback
calls (one per chunk) compare under ``tests/torch_helpers.py``'s rule:
ints exact, floats to rtol 1e-12."""

import pytest
from torch_helpers import PLAYBACK_STOCK, assert_both_match, mixed_feed

P = "partition with (symbol of S) begin @info(name='q') "
RANGE = ("partition with (price < 30.0 as 'lo' or price >= 20.0 and price < 70.0 "
         "as 'mid' or price >= 60.0 as 'hi' of S) begin @info(name='q') ")

APPS = {
    "session_latency": P + "from S#window.session(500 millisec, symbol, "
                           "200 millisec) select symbol, volume insert all "
                           "events into O; end;",
    "sort": P + "from S#window.sort(2, price) select symbol, sum(price) as p "
                "insert all events into O; end;",
    "frequent": P + "from S#window.frequent(1, volume) select symbol, volume "
                    "insert all events into O; end;",
    "lossy_frequent": P + "from S#window.lossyFrequent(0.3, 0.05, volume) select "
                          "symbol, volume insert all events into O; end;",
    "expression": P + "from S#window.expression('count() <= 2') select symbol, "
                      "sum(volume) as v insert all events into O; end;",
    "expression_batch": P + "from S#window.expressionBatch('count() <= 2') select "
                            "symbol, sum(volume) as v insert all events into O; end;",
    "time_group_having": P + "from S[volume > 10]#window.time(700 millisec) select "
                             "symbol, price, count() as n group by price having "
                             "n >= 1 insert all events into O; end;",
    "range": RANGE + "from S#window.length(3) select symbol, avg(price) as p, "
                     "count() as n insert into O; end;",
    "range_time": RANGE + "from S#window.time(1 sec) select symbol, sum(volume) "
                          "as v insert all events into O; end;",
    "inner_stream": "partition with (symbol of S) begin from S[volume > 30] select "
                    "symbol, price, volume insert into #Mid; @info(name='q') from "
                    "#Mid#window.length(2) select symbol, sum(volume) as v insert "
                    "into O; end;",
    "inner_chain_time": "partition with (symbol of S) begin from S#window.time(1 sec) "
                        "select symbol, sum(volume) as v insert all events into "
                        "#Mid; from #Mid[v > 50] select symbol, v insert into #Hi; "
                        "@info(name='q') from #Hi#window.lengthBatch(2) select "
                        "symbol, max(v) as m insert into O; end;",
    "local_stream": "partition with (symbol of S) begin from S#window.lengthBatch(2) "
                    "select symbol, volume insert events into Mid; @info(name='q') "
                    "from Mid select symbol, volume insert into O; end;",
    "rate_limited_inner": "partition with (symbol of S) begin from S select symbol, "
                          "volume output last every 2 events insert into #Mid; "
                          "@info(name='q') from #Mid select symbol, sum(volume) as v "
                          "insert into O; end;",
}


@pytest.mark.parametrize("name", list(APPS))
def test_partition_shapes_match_reference(name):
    n = assert_both_match(PLAYBACK_STOCK + APPS[name], mixed_feed(7),
                          query_callback=True,
                          config={"siddhi_tpu.partition_window_capacity": "64"})
    assert n > 0
