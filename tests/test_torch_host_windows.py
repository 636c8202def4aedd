"""The host windows (``ops/host_windows.py``: sort, frequent,
lossyFrequent, session, cron, expression, expressionBatch) and the
runtime's host-window branch (filters and transforms before the window,
post-window stages after it, the device step running the selector), held
against the JAX package on the same seeded feeds under ``@app:playback``.

Tolerance (tests/torch_helpers.py): ints, strings, timestamps, types and
order exact; floats to rtol 1e-12."""

import pytest
from torch_helpers import PLAYBACK_STOCK, assert_both_match, mixed_feed

APPS = {
    "sort_desc": "from S#window.sort(3, price, 'desc') select symbol, price "
                 "insert all events into O;",
    "sort_two_keys_string": "from S#window.sort(4, symbol, 'asc', volume, 'desc') "
                            "select symbol, volume insert all events into O;",
    "frequent": "from S[volume > 10]#window.frequent(2, symbol) select symbol, "
                "volume insert all events into O;",
    "lossy_frequent": "from S#window.lossyFrequent(0.3, 0.05, symbol) "
                      "select symbol, volume insert all events into O;",
    "session": "from S#window.session(500 millisec, symbol) select symbol, "
               "sum(volume) as v group by symbol insert all events into O;",
    "session_latency": "from S#window.session(1 sec, symbol, 200 millisec) "
                       "select symbol, count() as n group by symbol "
                       "insert all events into O;",
    "cron": "from S#window.cron('*/2 * * * * ?') select symbol, volume "
            "insert all events into O;",
    "expression": "from S#window.expression('count() <= 3') select symbol, "
                  "sum(volume) as v insert all events into O;",
    "expression_batch": "from S#window.expressionBatch('count() <= 3') "
                        "select symbol, sum(volume) as v insert all events into O;",
    "post_window_stages": "from S#pol2Cart(price, volume)#window.sort(3, x)"
                          "[volume > 20] select symbol, x insert all events into O;",
}


@pytest.mark.parametrize("name", list(APPS))
def test_host_window_apps_match_reference(name):
    assert assert_both_match(PLAYBACK_STOCK + "@info(name='q') " + APPS[name],
                             mixed_feed(31, n_events=20, n_batches=2)) > 0


@pytest.mark.parametrize("window, what", [
    ("sort(2.5)", "attribute"),
    ("sort(2, 8)", "attribute"),
    ("session(1 sec, symbol, 2 sec)", "allowedLatency"),
    ("cron(5)", "cron"),
])
def test_bad_host_windows_are_refused(window, what):
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.ops.expressions import CompileError

    with pytest.raises(CompileError, match=what):
        SiddhiManager(device="cpu").create_siddhi_app_runtime(
            PLAYBACK_STOCK + f"from S#window.{window} select symbol insert into O;")
