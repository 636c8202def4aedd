"""Two dense intermediates of the port, cut down to the rows they carry.

- A group by over a pattern's captures keys the NFA's emission on the
  host. The emission is a ``[rows, slots + 1]`` match grid, mostly empty;
  only its emitted rows may cross to the host (``QueryRuntime.
  _host_keyed_select`` compacts it on the device first). At 65,536-row
  batches and 4,096 slots the whole grid is 268 million rows a column.
- A partitioned join against an incremental aggregation probes the
  aggregation's stitched buckets by the group attribute its ``on``
  condition equates (the planner's ``partition_agg_probe``), not through
  a ``[rows, buckets]`` compare: at 65,536 trigger rows and ~40,000
  buckets that compare asks the card for 32 GiB.

Each case also holds the port's rows against the reference's on the same
feed (``torch_helpers``: ints, strings, timestamps and order exact;
floats to rtol 1e-12).
"""

import numpy as np
import pytest
import torch

from torch_helpers import (Run, aggregation_join_feed, assert_rows_match,
                           release_jax_programs, send_multi, two_stream_feed)  # noqa: F401

torch.set_num_threads(1)

PATTERN_APP = """
@app:playback
define stream A (k string, v double);
define stream B (k string, v double);
@info(name = 'q')
from every e1=A -> e2=B[e2.v > e1.v] within 2 sec
select e1.k as k, sum(e2.v) as total, count() as c
group by e1.k
insert into Out;
"""

AGG_JOIN = """
@app:playback
define stream L (k string, v double{lper});
define stream R (k string, v double);
define aggregation Agg from R select k, sum(v) as t, count() as c
  group by k aggregate every sec ... min;
partition with (k of L)
begin
  @info(name = 'q')
  from L#window.length(4) join Agg on L.k == Agg.k
    within 0L, 100000000L per {per}
  select L.k as k, L.v as lv, Agg.AGG_TIMESTAMP as at, Agg.t as t, Agg.c as c
  insert into Out;
end;
"""


def test_host_keyed_select_pulls_only_the_emitted_rows():
    """The keyer of an unpartitioned pattern's group by sees the emitted
    matches only: every row it is handed is valid, far fewer than the
    grid's rows, and the rows equal the reference's."""
    config = {"siddhi_tpu.nfa_slots": "256"}
    feed = two_stream_feed(seed=4, n_items=30, n_keys=7)
    want = Run("jax", PATTERN_APP, "Out", "q", config=config)
    send_multi(want.rt, feed)
    want = want.close()
    run = Run("torch", PATTERN_APP, "Out", "q", config=config)
    q = run.query
    seen = []

    class Spy:
        """The query's keyer, recording the rows each call is handed."""

        def __init__(self, keyer):
            self.keyer = keyer

        def __call__(self, cols, pk=None):
            valid = np.asarray(cols["__valid__"])
            seen.append((valid.shape[0], int(valid.sum())))
            return self.keyer(cols, pk=pk)

        def __len__(self):
            return len(self.keyer)

        def __getattr__(self, name):
            return getattr(self.keyer, name)

    q.keyer = Spy(q.keyer)
    send_multi(run.rt, feed)
    got = run.close()
    assert want and seen
    assert all(n == v for n, v in seen), seen
    assert max(n for n, _v in seen) < 257, seen
    assert_rows_match(got, want)


@pytest.mark.parametrize("per,lper", [("'seconds'", ""), ("L.per", ", per string")],
                         ids=["fixed", "per_event"])
def test_partitioned_aggregation_join_probes_by_key(per, lper):
    """Inside a partition the join probes the aggregation's buckets by
    ``Agg.k`` with a candidate window as wide as the longest run of one
    key, the reference's eligibility reads (``index_probe``) untouched,
    and the rows equal the reference's."""
    app = AGG_JOIN.format(per=per, lper=lper)
    feed = aggregation_join_feed(seed=6, n_items=30, n_keys=7)
    want = Run("jax", app, "Out", "q")
    send_multi(want.rt, feed)
    want = want.close()
    run = Run("torch", app, "Out", "q")
    q = run.query
    assert q.index_probe is None
    assert q.partition_agg_probe["attr"] == "k"
    store = next(s.store for s in q.sides.values() if s.store is not None)
    max_run, widths = store.max_run, []

    def spy(cols, valid, attr):
        widths.append(max_run(cols, valid, attr))
        return widths[-1]

    store.max_run = spy
    send_multi(run.rt, feed)
    got = run.close()
    assert want and widths
    assert_rows_match(got, want)
