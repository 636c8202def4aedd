"""Stream-stream joins on the port (``core/query/join_runtime.py``, the
partitioned engine ``core/join/engine.py``) against the reference, on the
CPU.

Seeded two-stream feeds (single events and 8-row column batches, clocks
that stand still, creep and jump; ``torch_helpers.two_stream_feed``) go
through both packages for each join shape: inner, left/right/full outer
and unidirectional joins over length, time, externalTime, lengthBatch and
windowless sides, a grouped aggregate (the host-keyed split path), and a
join inside a partition. The partitioned engine at an explicit P = 4
(sub-windows engaged) and the broadcast probe (``join_engine = legacy``)
must each equal the reference row for row: ints, strings, timestamps,
types and order exactly, floats to rtol 1e-12 (``torch_helpers``).
"""

import numpy as np
import pytest

from torch_helpers import (  # release_jax_programs: an autouse fixture
    Run, assert_multi_match, assert_rows_match, release_jax_programs,
    run_both_multi, send_multi, two_stream_feed)

HEAD = """@app:playback
define stream A (k string, v double);
define stream B (k string, v double);
"""

ENGINE = {"siddhi_tpu.join_partitions": "4"}
LEGACY = {"siddhi_tpu.join_engine": "legacy"}

SHAPES = {
    "inner_length": """
        @info(name='q') from A#window.length(32) join B#window.length(16)
        on A.k == B.k select A.k as k, A.v as av, B.v as bv insert into O;""",
    "left_outer_time": """
        @info(name='q') from A#window.time(2 sec) left outer join B#window.length(20)
        on A.k == B.k and A.v > B.v
        select A.k as k, A.v as av, B.v as bv insert all events into O;""",
    "right_outer_time": """
        @info(name='q') from A#window.length(24) right outer join B#window.time(1 sec)
        on A.k == B.k select B.k as k, A.v as av, B.v as bv insert into O;""",
    "full_outer": """
        @info(name='q') from A#window.length(20) full outer join B#window.length(20)
        on A.k == B.k select A.v as av, B.v as bv insert into O;""",
    "unidirectional": """
        @info(name='q') from A#window.length(20) unidirectional join B#window.length(20)
        on A.k == B.k select A.k as k, A.v as av, B.v as bv insert into O;""",
    "length_batch": """
        @info(name='q') from A#window.lengthBatch(5) join B#window.length(20)
        on A.k == B.k select A.k as k, A.v as av, B.v as bv insert all events into O;""",
    "windowless_side": """
        @info(name='q') from A join B#window.length(20)
        on A.k == B.k select A.k as k, A.v as av, B.v as bv insert into O;""",
    "grouped_aggregate": """
        @info(name='q') from A#window.length(8) join B#window.length(8)
        on A.k == B.k select A.k as k, count() as n, sum(B.v) as s
        group by A.k insert into O;""",
    "float_key": """
        @info(name='q') from A#window.length(32) join B#window.length(32)
        on A.v == B.v select A.k as ak, B.k as bk insert into O;""",
}


def _port_rows(app, feed, config):
    r = Run("torch", app, "O", "q", config=config)
    send_multi(r.rt, feed)
    return r.close()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_join_shapes_match_reference(shape):
    """One reference run, and the port with the engine (P = 4) and with
    the broadcast probe, each equal to it."""
    app = HEAD + SHAPES[shape]
    feed = two_stream_feed(7 + len(shape), n_items=36)
    want = run_both_multi(app, feed)
    assert_rows_match(want["torch"], want["jax"])
    for cfg in (ENGINE, LEGACY):
        assert_rows_match(_port_rows(app, feed, cfg), want["jax"])
    assert want["jax"]


EXT_HEAD = """@app:playback
define stream A (k string, v double, t long);
define stream B (k string, v double, t long);
"""


def _with_clock(feed, seed):
    """``two_stream_feed`` items with an event-time attribute ``t`` that
    jitters around the timestamp (an external clock that is not monotone)."""
    rng = np.random.default_rng(seed)
    out = []
    for stream, a, b in feed:
        if isinstance(a, dict):
            cols = dict(a)
            cols["t"] = np.asarray(b, np.int64) + rng.integers(-300, 300, len(b))
            out.append((stream, cols, b))
        else:
            out.append((stream, a, b + [int(a) + int(rng.integers(-300, 300))]))
    return out


def test_external_time_join_matches_reference():
    app = EXT_HEAD + """
        @info(name='q') from A#window.externalTime(t, 1 sec) join B#window.length(24)
        on A.k == B.k select A.k as k, A.t as at, B.v as bv insert all events into O;"""
    feed = _with_clock(two_stream_feed(31, n_items=36), 5)
    assert assert_multi_match(app, feed, config=ENGINE) > 0


def test_partitioned_join_matches_reference():
    app = HEAD + """
        partition with (k of A, k of B)
        begin
          @info(name='q') from A#window.length(4) join B#window.time(1 sec)
          on A.v > B.v select A.k as k, A.v as av, B.v as bv insert into O;
        end;"""
    feed = two_stream_feed(41, n_items=36, n_keys=5)
    assert assert_multi_match(app, feed) > 0


def test_engine_partitions_both_sides_and_equals_legacy():
    """At P = 4 both sides of ``inner_length`` run the partition-local
    probe, and its rows equal the broadcast probe's on the port itself."""
    app = HEAD + SHAPES["inner_length"]
    feed = two_stream_feed(3, n_items=40)
    r = Run("torch", app, "O", "q", config=ENGINE)
    q = r.query
    assert q.engine is not None and q.engine.P == 4
    assert all(p.use_pidx for p in q.engine.plans.values())
    send_multi(r.rt, feed)
    rows = r.close()
    assert rows == _port_rows(app, feed, LEGACY) and rows
