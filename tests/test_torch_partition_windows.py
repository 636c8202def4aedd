"""The keyed device windows inside ``partition with`` in the port against
the JAX package, app by app under ``@app:playback`` on ``mixed_feed``
(single events, then column batches, with clock jumps that fire timers
between and inside sends): time, externalTime, timeLength, lengthBatch,
timeBatch, batch, hopping, delay and session, and a filtered, grouped
time window with having. Stream rows and QueryCallback calls (one per
chunk) compare under ``tests/torch_helpers.py``'s rule: ints exact,
floats to rtol 1e-12."""

import pytest
from torch_helpers import (
    PLAYBACK_STOCK, assert_both_match, mixed_feed, release_jax_programs)

P = "partition with (symbol of S) begin @info(name='q') "

APPS = {
    "time": P + "from S#window.time(1 sec) select symbol, sum(volume) as v, "
                "count() as n insert all events into O; end;",
    "external_time": P + "from S#window.externalTime(ts, 1 sec) select symbol, "
                         "sum(volume) as v insert all events into O; end;",
    "time_length": P + "from S#window.timeLength(2 sec, 3) select symbol, "
                       "sum(volume) as v insert all events into O; end;",
    "length_batch": P + "from S#window.lengthBatch(3) select symbol, "
                        "sum(volume) as v insert all events into O; end;",
    "time_batch": P + "from S#window.timeBatch(1 sec) select symbol, "
                      "sum(volume) as v insert all events into O; end;",
    "batch": P + "from S#window.batch() select symbol, sum(volume) as v "
                 "insert all events into O; end;",
    "hopping": P + "from S#window.hopping(2 sec, 500 millisec) select symbol, "
                   "count() as n insert all events into O; end;",
    "delay": P + "from S#window.delay(600 millisec) select symbol, volume "
                 "insert into O; end;",
    "session": P + "from S#window.session(500 millisec) select symbol, "
                   "count() as n, sum(volume) as v insert all events into O; end;",
}


@pytest.mark.parametrize("name", list(APPS))
def test_partition_apps_match_reference(name):
    n = assert_both_match(PLAYBACK_STOCK + APPS[name], mixed_feed(7),
                          query_callback=True,
                          config={"siddhi_tpu.partition_window_capacity": "64"})
    assert n > 0
