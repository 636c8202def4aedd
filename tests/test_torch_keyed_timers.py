"""Swept TIMER chains of the keyed time, timeLength and session windows.

A playback keyed time window asks for a timer at its oldest row's time +
t over all keys, a keyed session at its earliest key's last row + gap:
over many keys that is a TIMER step per millisecond of event time, each a
chunk of its own. The port sweeps the chain in one step where nothing
can tell the difference; these tests run each app three ways: swept,
with ``QueryRuntime._sweep_horizon`` forced to None (one step per tick),
and in the reference. All three give equal rows, timestamps and chunks
(QueryCallback calls, one per chunk), and the swept run takes fewer TIMER
steps. Tolerance (tests/torch_helpers.py): ints exact, floats to rtol
1e-12."""

import numpy as np
import pytest
from torch_helpers import Run, assert_rows_match, release_jax_programs

from siddhi_tpu_torch.core.query.runtime import QueryRuntime

HEAD = ("@app:playback define stream S (symbol string, price double, "
        "volume long, ts long);\npartition with (symbol of S) begin "
        "@info(name='q') ")

APPS = {
    "time": HEAD + "from S#window.time(100 millisec) select symbol, sum(volume) "
                   "as v, count() as n insert all events into O; end;",
    "time_length": HEAD + "from S#window.timeLength(100 millisec, 3) select symbol, "
                          "sum(volume) as v insert all events into O; end;",
    "session": HEAD + "from S#window.session(100 millisec) select symbol, count() "
                      "as n, sum(volume) as v insert all events into O; end;",
    "time_filtered": HEAD + "from S#window.time(50 millisec)[volume > 3] select "
                            "symbol, volume insert expired events into O; end;",
}


def _feed(seed, n_keys, n_rows, spread=1):
    """Rows ``spread`` ms apart over ``n_keys`` symbols, then batches and a
    clock jump that fires the whole chain."""
    rng = np.random.default_rng(seed)
    syms = np.array([f"K{i}" for i in range(n_keys)], dtype=object)
    feed = []
    t = 1000
    for _ in range(n_rows):
        t += int(rng.integers(0, spread + 1))
        feed.append(("event", t, [str(syms[rng.integers(0, n_keys)]),
                                  float(rng.integers(0, 100)), int(rng.integers(1, 9)),
                                  t]))
    for _ in range(2):
        B = 16
        ts = t + np.sort(rng.integers(1, 150, B)).astype(np.int64)
        feed.append(("cols", {"symbol": syms[rng.integers(0, n_keys, B)],
                              "price": rng.integers(0, 100, B).astype(np.float64),
                              "volume": rng.integers(1, 9, B), "ts": ts}, ts))
        t = int(ts.max())
    feed.append(("event", t + 1000, ["K0", 1.0, 1, t + 1000]))
    return feed


def _run(pkg, app, feed, sweep=True):
    steps = [0]
    orig = QueryRuntime.process_timer
    orig_h = QueryRuntime._sweep_horizon

    def counted(self, ts):
        steps[0] += 1
        return orig(self, ts)

    QueryRuntime.process_timer = counted
    if not sweep:
        QueryRuntime._sweep_horizon = lambda self, ts: None
    try:
        r = Run(pkg, app, "O", "q", query_callback=True).feed("S", feed)
        rows = r.close()
    finally:
        QueryRuntime.process_timer = orig
        QueryRuntime._sweep_horizon = orig_h
    return rows, r.query_collector.calls, steps[0]


def _same(a, b):
    rows_a, calls_a, _ = a
    rows_b, calls_b, _ = b
    assert_rows_match(rows_a, rows_b)
    assert len(calls_a) == len(calls_b), (len(calls_a), len(calls_b))
    for (t1, i1, r1), (t2, i2, r2) in zip(calls_a, calls_b):
        assert t1 == t2
        assert_rows_match(i1, i2)
        assert_rows_match(r1, r2)


@pytest.mark.parametrize("name", list(APPS))
def test_swept_keyed_chain_equals_unswept_and_reference(name):
    feed = _feed(5, 12, 24)
    swept = _run("torch", APPS[name], feed)
    unswept = _run("torch", APPS[name], feed, sweep=False)
    ref = _run("jax", APPS[name], feed)
    assert swept[0]
    _same(swept, ref)
    _same(unswept, ref)
    # one step per tick against a few swept steps
    assert swept[2] < unswept[2], (swept[2], unswept[2])


def test_swept_session_splits_a_tick_past_128_keys():
    """200 keys whose sessions end at one tick: the reference drains 128,
    re-arms at the same tick and drains 72 (two chunks at one timestamp);
    the swept step gives the same two chunks."""
    syms = np.array([f"K{i}" for i in range(200)], dtype=object)
    ts = np.full(200, 1000, np.int64)
    feed = [("cols", {"symbol": syms, "price": np.ones(200), "volume": np.ones(200, np.int64),
                      "ts": ts}, ts),
            ("event", 1050, ["K0", 1.0, 1, 1050]),
            ("event", 5000, ["K1", 1.0, 1, 5000])]
    app = APPS["session"]
    swept = _run("torch", app, feed)
    ref = _run("jax", app, feed)
    _same(swept, ref)
    # the expired rows of the big tick arrive in two callback calls
    at_tick = [c for c in ref[1] if c[2] and c[0] == 1100]
    assert [len(c[2]) for c in at_tick] == [128, 71]
