"""Output rate limiting (``core/query/ratelimit.py`` and its wiring), held
against the JAX package on the same seeded feeds under ``@app:playback``:
the shapes of the event, time and snapshot rate-limit corpora, with their
group variants (the group key projected or not) and, inside a value
partition, one limiter per key. Stream rows and QueryCallback calls
(snapshot limiters' empty flushes included) are compared.

Tolerance (tests/torch_helpers.py): ints, strings, timestamps, types and
order exact; floats to rtol 1e-12."""

import pytest
from torch_helpers import PLAYBACK_STOCK, assert_both_match, mixed_feed

APPS = {
    "event_all": "from S select symbol, volume output every 3 events insert into O;",
    "event_first": "from S select symbol, volume output first every 4 events "
                   "insert into O;",
    "event_last": "from S select symbol, volume output last every 3 events "
                  "insert into O;",
    "event_first_grouped": "from S select symbol, sum(volume) as v group by symbol "
                           "output first every 3 events insert into O;",
    "event_last_grouped_key_not_projected": "from S select sum(volume) as v "
                                            "group by symbol output last every 3 "
                                            "events insert into O;",
    "time_all": "from S select symbol, volume output every 1 sec insert into O;",
    "time_first": "from S select symbol, volume output first every 1 sec "
                  "insert into O;",
    "time_last_grouped_window": "from S#window.time(1 sec) select symbol, "
                                "sum(volume) as v group by symbol "
                                "output last every 1 sec insert into O;",
    "snapshot_window_no_agg": "from S#window.length(3) select symbol, volume "
                              "output snapshot every 1 sec insert all events into O;",
    "snapshot_window_grouped": "from S#window.time(2 sec) select symbol, "
                               "sum(volume) as v group by symbol "
                               "output snapshot every 1 sec insert all events into O;",
    "snapshot_no_window_agg": "from S select sum(volume) as v, count() as n "
                              "output snapshot every 700 millisec "
                              "insert all events into O;",
}


@pytest.mark.parametrize("name", list(APPS))
def test_rate_limited_apps_match_reference(name):
    n = assert_both_match(PLAYBACK_STOCK + "@info(name='q') " + APPS[name],
                          mixed_feed(23, n_events=20, n_batches=2),
                          query_callback=True,
                          config={"siddhi_tpu.window_capacity": "256"})
    assert n > 0


PARTITIONED = {
    "event_last": "from S#window.length(3) select symbol, sum(volume) as v "
                  "output last every 2 events insert into O;",
    "time_all": "from S select symbol, volume output every 1 sec insert into O;",
    "snapshot": "from S#window.length(2) select symbol, sum(volume) as v "
                "output snapshot every 1 sec insert all events into O;",
}


@pytest.mark.parametrize("name", list(PARTITIONED))
def test_partitioned_rate_limiters_match_reference(name):
    app = (PLAYBACK_STOCK + "partition with (symbol of S) begin @info(name='q') "
           + PARTITIONED[name] + " end;")
    assert assert_both_match(app, mixed_feed(29, n_events=20, n_batches=2),
                             query_callback=True) > 0


def test_snapshot_rate_needs_all_events():
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException

    with pytest.raises(SiddhiAppValidationException, match="ALL_EVENTS"):
        SiddhiManager(device="cpu").create_siddhi_app_runtime(
            PLAYBACK_STOCK + "from S select symbol output snapshot every 1 sec "
            "insert into O;")
