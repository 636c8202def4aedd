"""Every shape the key-sharded step splits across processes, on the CPU:
spawned gloo groups of 2 and of 4 processes (on ``127.0.0.1`` and a free
port) install ``shard_query_step`` over ``global_mesh()`` on each shape's
queries, feed every process the same events, and every process's rows
are held against the reference's single-process rows.

The shapes, one parametrised case each:

- ``group_by``: a partitioned query grouped by a key other than the
  partition key (``torch_helpers.DISTINCT_GK_APP``): the group ids reach
  their owner's local space through the layout's LUT;
- ``group_by_distinct``: the same with ``distinctCount(volume)``, whose
  value tables shard by group and run the distinct scan on each process;
- ``order_limit_batch``: having, order by and limit behind a global
  ``lengthBatch`` (the selector split by group);
- ``order_limit_partitioned``: having, order by, offset and limit over a
  partitioned ``length`` window (the ordering runs once, on the merged
  rows);
- ``keyed_windows``: ``time``, ``timeBatch``, ``externalTime`` and
  ``session`` inside one partition, under ``@app:playback`` (their TIMER
  steps, swept chains included);
- ``more_keyed_windows``: ``lengthBatch``, ``timeLength``, ``hopping``
  and ``batch`` inside one partition;
- ``host_window``: a partitioned ``sort`` window (one host instance a
  key, each process holding its own keys');
- ``inner_stream``: a partitioned query feeding a partition-mate through
  an inner ``#stream`` (rows carry the partition key); the mate splits,
  the stateless producer runs whole;
- ``pattern_group_by``: a partitioned pattern grouped by a capture: the
  match slots split by partition key, and the host keys the merged
  matches and selects on every process, its selector state whole;
- ``partitioned_join``: a partitioned join of a ``length`` and a ``time``
  window, each side split at the input, the matches merged in the
  unsharded (trigger row, slot) order; its 40 keys grow the layout
  mid-feed at 2 processes;
- ``unpartitioned_join``: a grouped join with no partition runs whole on
  every process (no key axis to split);
- ``pattern_order_by``: a partitioned pattern's order by / limit without
  a group by: the selection runs unordered on each process and the
  ordering once, on the merged rows;
- ``join_order_by``: the same for a partitioned join;
- ``join_group_by`` and ``join_aggregation``: a partitioned join grouped
  by a joined column, and aggregated without a group by (one group across
  partition keys): the matches merge, and the selector runs on every
  process with its state whole;
- ``delay_window``: the ``delay`` window inside a partition, whose ring
  has no key axis: every process runs it whole, and the selector splits.

- ``join_global_side``, ``join_batch_window_side``, ``join_store_side``:
  a partitioned join of a ``length`` window with an unpartitioned
  stream's window (each row copied to every global key, each process
  keeping its own keys'), with a ``lengthBatch`` window, and with a table
  filled by a query outside the partition (whole on every process, the
  probe surface of each trigger row on its owner process).
- ``join_aggregation_side`` and ``join_aggregation_per_event``: a
  partitioned join against an incremental aggregation defined outside the
  partition, with a fixed ``per 'seconds'`` and with a per-event
  ``per L.per`` (the trigger rows grouped by their duration, one probe a
  group): every process folds the whole stream into the same buckets, and
  each trigger row probes them on its owner process;
- ``pattern_unpartitioned_group_by``, ``sequence_unpartitioned_group_by``,
  ``pattern_unpartitioned_group_order`` and
  ``absent_unpartitioned_group_by``: an unpartitioned pattern, a
  sequence, a pattern with an order by / limit and an absent pattern
  (``not ... for``: its TIMER sweeps), each grouped by a capture: the
  NFA's match slots have no key axis, so each runs whole on every
  process, as an unpartitioned join does.

``join_aggregation_unserved`` adds a query asking the aggregation for a
duration it does not keep: each process drops the trigger rows and logs
the reference's error as often as the reference does. The split mode of
the two shapes ROADMAP A.11 closed is checked without a process group.

The children import ``siddhi_tpu_torch`` only, and each asserts at its
end that neither ``jax`` nor ``siddhi_tpu`` was imported; no shape may
log a processing error in any process (a junction logs a failed batch
and drops it, which a comparison of rows can miss). Tolerance
(``torch_helpers``): ints, strings, timestamps and order exact; floats to
rtol 1e-12.
"""

import logging
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from torch_helpers import (
    DISTINCT_GK_APP,
    PLAYBACK_STOCK,
    assert_rows_match,
    release_jax_programs,  # noqa: F401 — autouse fixture: frees JAX programs
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

GK_DISTINCT_APP = DISTINCT_GK_APP.replace(
    "sum(volume) as tv", "sum(volume) as tv, distinctCount(volume) as dv")

ORDER_BATCH_APP = PLAYBACK_STOCK + """
@info(name = 'q')
from S#window.lengthBatch(6)
select symbol, sum(volume) as tv, max(price) as mp
group by symbol having tv > 20
order by tv desc, symbol limit 3
insert into Out;
"""

ORDER_PARTITIONED_APP = PLAYBACK_STOCK + """
partition with (symbol of S)
begin
  @info(name = 'q')
  from S#window.length(4)
  select symbol, avg(price) as ap, sum(volume) as tv
  having tv > 10
  order by ap desc limit 5 offset 1
  insert into Out;
end;
"""

WINDOWS_APP = PLAYBACK_STOCK + """
partition with (symbol of S)
begin
  @info(name = 'qt') from S#window.time(1 sec)
  select symbol, sum(volume) as tv, count() as c insert all events into OT;
  @info(name = 'qtb') from S#window.timeBatch(1 sec)
  select symbol, sum(volume) as tv insert into OTB;
  @info(name = 'qet') from S#window.externalTime(ts, 800 millisec)
  select symbol, max(price) as mp, avg(price) as ap insert all events into OET;
  @info(name = 'qs') from S#window.session(500 millisec)
  select symbol, sum(volume) as tv, count() as c insert all events into OS;
end;
"""

MORE_WINDOWS_APP = PLAYBACK_STOCK + """
partition with (symbol of S)
begin
  @info(name = 'qlb') from S#window.lengthBatch(3)
  select symbol, sum(volume) as tv insert all events into OLB;
  @info(name = 'qtl') from S#window.timeLength(1 sec, 3)
  select symbol, sum(volume) as tv insert all events into OTL;
  @info(name = 'qh') from S#window.hopping(1 sec, 500 millisec)
  select symbol, count() as c insert into OH;
  @info(name = 'qb') from S#window.batch()
  select symbol, max(price) as mp insert into OB;
end;
"""

HOST_WINDOW_APP = PLAYBACK_STOCK + """
partition with (symbol of S)
begin
  @info(name = 'q') from S#window.sort(3, price)
  select symbol, sum(volume) as tv, min(price) as lo insert all events into Out;
end;
"""

INNER_STREAM_APP = PLAYBACK_STOCK + """
partition with (symbol of S)
begin
  @info(name = 'q1') from S[volume > 5]
  select symbol, price * 2.0 as p2, volume insert into #T;
  @info(name = 'q2') from #T#window.length(3)
  select symbol, sum(p2) as sp, count() as c insert into Out;
end;
"""

PATTERN_GROUP_APP = """
@app:playback
define stream A (k string, v double);
define stream B (k string, v double);
partition with (k of A, k of B)
begin
  @info(name = 'q')
  from every e1=A -> e2=B[e2.v > e1.v] within 2 sec
  select e1.v as v1, sum(e2.v) as total, count() as c
  group by e1.v
  insert into Out;
end;
"""

JOIN_APP = """
@app:playback
define stream L (k string, v double);
define stream R (k string, v double);
partition with (k of L, k of R)
begin
  @info(name = 'q')
  from L#window.length(4) join R#window.time(1 sec)
    on L.v > R.v
  select L.k as k, L.v as lv, R.v as rv
  insert into Out;
end;
"""

JOIN_GROUP_APP = JOIN_APP.replace(
    "select L.k as k, L.v as lv, R.v as rv", "select L.k as k, count() as n").replace(
    "insert into Out", "group by L.v insert into Out")

JOIN_ORDER_APP = JOIN_APP.replace("insert into Out", "order by rv desc, lv limit 4 "
                                  "insert into Out")

JOIN_AGG_APP = JOIN_APP.replace(
    "select L.k as k, L.v as lv, R.v as rv",
    "select L.k as k, sum(R.v) as total, count() as n")

PATTERN_ORDER_APP = PATTERN_GROUP_APP.replace("group by e1.v", "order by v1 limit 3").replace(
    ", sum(e2.v) as total, count() as c", "")

DELAY_APP = (PLAYBACK_STOCK + "partition with (symbol of S) begin @info(name = 'q') "
             "from S#window.delay(1 sec) select symbol, sum(volume) as tv insert into Out; "
             "end;")

# a partitioned join's other sides: a table (R's rows, inserted by a
# query outside the partition), a global (unpartitioned) stream, a batch
# window (a host window cannot be a join side inside a partition: it has
# no per-key probe surface)
# a partitioned join against an incremental aggregation outside the
# partition: a fixed duration ({per} a literal) or each trigger row's own
# ({per} ``L.per``, with ``{lper}`` the column)
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

# a second query asks for hours, which 'sec ... min' does not keep
AGG_JOIN_UNSERVED = AGG_JOIN.format(lper="", per="'seconds'") + """
partition with (k of L)
begin
  @info(name = 'qd')
  from L#window.length(4) join Agg on L.k == Agg.k
    within 0L, 100000000L per 'hours'
  select L.k as k, Agg.t as t insert into OutD;
end;
"""

# unpartitioned patterns grouped by a capture
UNPARTITIONED_PATTERN = """
@app:playback
define stream A (k string, v double);
define stream B (k string, v double);
@info(name = 'q')
from {body}
select e1.k as k, sum(e2.v) as total, count() as c
group by e1.k {tail}
insert into Out;
"""

ABSENT_GROUP_APP = """
@app:playback
define stream A (k string, v double);
define stream B (k string, v double);
@info(name = 'q')
from every e1=A[v > 5.0] -> not B[v > e1.v] for 1 sec
select e1.k as k, count() as c, max(e1.v) as top
group by e1.k
insert into Out;
"""

JOIN_SIDES = """
@app:playback
define stream L (k string, v double);
define stream R (k string, v double);
define table T (k string, v double);
from R select k, v insert into T;
partition with (k of L{pr})
begin
  @info(name = 'q')
  from L#window.length(4) join {right} on L.v > {rname}.v
  select L.k as k, L.v as lv, {rname}.v as rv
  insert into Out;
end;
"""


GLOBAL_JOIN_APP = """
@app:playback
define stream L (k string, v double);
define stream R (k string, v double);
@info(name = 'q')
from L#window.length(4) join R#window.length(4)
  on L.k == R.k
select L.k as k, count() as n, max(R.v) as top
group by L.k
insert into Out;
"""

# name -> (app, the queries given to shard_query_step, the output
# streams, the feed)
SHAPES = {
    "group_by": (DISTINCT_GK_APP, ["q"], ["Out"], "side"),
    "group_by_distinct": (GK_DISTINCT_APP, ["q"], ["Out"], "side"),
    "order_limit_batch": (ORDER_BATCH_APP, ["q"], ["Out"], "mixed"),
    "order_limit_partitioned": (ORDER_PARTITIONED_APP, ["q"], ["Out"], "mixed"),
    "keyed_windows": (WINDOWS_APP, ["qt", "qtb", "qet", "qs"],
                      ["OT", "OTB", "OET", "OS"], "mixed"),
    "more_keyed_windows": (MORE_WINDOWS_APP, ["qlb", "qtl", "qh", "qb"],
                           ["OLB", "OTL", "OH", "OB"], "mixed"),
    "host_window": (HOST_WINDOW_APP, ["q"], ["Out"], "mixed"),
    "inner_stream": (INNER_STREAM_APP, ["q1", "q2"], ["Out"], "mixed"),
    "pattern_group_by": (PATTERN_GROUP_APP, ["q"], ["Out"], "pattern"),
    "partitioned_join": (JOIN_APP, ["q"], ["Out"], "join"),
    "unpartitioned_join": (GLOBAL_JOIN_APP, ["q"], ["Out"], "join"),
    "pattern_order_by": (PATTERN_ORDER_APP, ["q"], ["Out"], "pattern"),
    "join_order_by": (JOIN_ORDER_APP, ["q"], ["Out"], "join"),
    "join_group_by": (JOIN_GROUP_APP, ["q"], ["Out"], "join"),
    "join_aggregation": (JOIN_AGG_APP, ["q"], ["Out"], "join"),
    "delay_window": (DELAY_APP, ["q"], ["Out"], "mixed"),
    "join_global_side": (JOIN_SIDES.format(pr="", right="R#window.length(4)", rname="R"),
                         ["q"], ["Out"], "join"),
    "join_batch_window_side": (JOIN_SIDES.format(pr=", k of R",
                                                 right="R#window.lengthBatch(4)",
                                                 rname="R"), ["q"], ["Out"], "join"),
    "join_store_side": (JOIN_SIDES.format(pr="", right="T", rname="T"), ["q"], ["Out"],
                        "join"),
    "join_aggregation_side": (AGG_JOIN.format(lper="", per="'seconds'"), ["q"], ["Out"],
                              "aggregation"),
    "join_aggregation_per_event": (AGG_JOIN.format(lper=", per string", per="L.per"),
                                   ["q"], ["Out"], "aggregation"),
    "pattern_unpartitioned_group_by": (UNPARTITIONED_PATTERN.format(
        body="every e1=A -> e2=B[e2.v > e1.v] within 2 sec", tail=""),
        ["q"], ["Out"], "pattern"),
    "sequence_unpartitioned_group_by": (UNPARTITIONED_PATTERN.format(
        body="every e1=A, e2=B", tail=""), ["q"], ["Out"], "pattern"),
    "pattern_unpartitioned_group_order": (UNPARTITIONED_PATTERN.format(
        body="every e1=A -> e2=B[e2.v > e1.v] within 2 sec",
        tail="order by total desc, k limit 3"), ["q"], ["Out"], "pattern"),
    "absent_unpartitioned_group_by": (ABSENT_GROUP_APP, ["q"], ["Out"], "pattern"),
}

# shapes whose queries log a processing error by design (each process as
# the reference does), held by their own test
ERROR_SHAPES = {
    "join_aggregation_unserved": (AGG_JOIN_UNSERVED, ["q", "qd"], ["Out", "OutD"],
                                  "one_trigger"),
}

# where each query of a shape takes its rows: at the input, at the
# selector, or nowhere (None: a query with no keyed state runs whole)
SPLITS = {"order_limit_batch": ["select"], "inner_stream": [None, "input"],
          "unpartitioned_join": [None], "delay_window": ["select"],
          "pattern_unpartitioned_group_by": [None],
          "sequence_unpartitioned_group_by": [None],
          "pattern_unpartitioned_group_order": [None],
          "absent_unpartitioned_group_by": [None],
          "join_aggregation_unserved": ["input", "input"]}

# the feeds, made from a seed in every process alike (numpy only): a
# torch_helpers generator, its arguments, and its sender (stream S's
# ``send_feed`` or the multi-stream ``send_multi``)
FEEDS = {
    "side": ("side_feed", dict(seed=2, n_batches=3, batch=64, n_symbols=13,
                               n_sides=5, n_events=16), "send_feed"),
    "mixed": ("mixed_feed", dict(seed=3, n_events=20, n_batches=3, batch=16,
                                 n_symbols=9), "send_feed"),
    "pattern": ("two_stream_feed", dict(seed=4, streams=("A", "B"), n_items=30,
                                        n_keys=7), "send_multi"),
    # 40 keys: past the 2-process layout's 32 key rows, so the join's
    # capacity grows mid-feed (a state gather and a relayout)
    "join": ("two_stream_feed", dict(seed=5, streams=("L", "R"), n_items=30,
                                     n_keys=40), "send_multi"),
    "aggregation": ("aggregation_join_feed", dict(seed=6, n_items=30, n_keys=7),
                    "send_multi"),
    # one send on L: the unservable query logs once
    "one_trigger": ("aggregation_join_feed", dict(seed=7, n_items=30, n_keys=7,
                                                  triggers=1), "send_multi"),
}

WORKER = textwrap.dedent('''
    import os
    import pickle
    import sys

    root, port, P, rank, out = sys.argv[1:6]
    P, rank = int(P), int(rank)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch

    torch.set_num_threads(1)
    from siddhi_tpu_torch.parallel import distributed

    distributed.initialize_cluster(f"127.0.0.1:{port}", P, rank, device="cpu")
    import siddhi_tpu_torch
    import torch_helpers
    from siddhi_tpu_torch.parallel.mesh import shard_query_step

    import logging

    class Errors(logging.Handler):
        """The processing errors the engine logs (a junction logs a
        failed batch and drops it)."""

        def __init__(self):
            super().__init__(logging.ERROR)
            self.seen = []

        def emit(self, record):
            self.seen.append(record.getMessage()[:300])

    errors = Errors()
    logging.getLogger("siddhi_tpu_torch").addHandler(errors)
    SHAPES, FEEDS = pickle.loads(bytes.fromhex(sys.argv[6]))
    res = {}
    for name, (app, queries, streams, feed) in SHAPES.items():
        errors.seen = []
        m = siddhi_tpu_torch.SiddhiManager(device="cpu")
        rt = m.create_siddhi_app_runtime(app)
        sinks = {}
        for s in streams:
            sinks[s] = torch_helpers.make_collector(siddhi_tpu_torch.StreamCallback)
            rt.add_callback(s, sinks[s])
        splits = []
        for q in queries:
            qr = rt.query_runtimes[q]
            shard_query_step(qr, distributed.global_mesh())
            layout = qr._route_layout       # None: no keyed state, run whole
            splits.append(None if layout is None else layout.split)
        torch_helpers.drive(rt, *FEEDS[feed])
        m.shutdown()
        res[name] = (splits, {s: c.rows for s, c in sinks.items()}, errors.seen)
    bad = [k for k in sys.modules if k in ("jax", "siddhi_tpu")
           or k.startswith(("jax.", "siddhi_tpu."))]
    assert not bad, bad
    res["imports_clean"] = True
    with open(out, "wb") as f:
        pickle.dump(res, f)
    os._exit(0)
''')

PROCESSES = (2, 4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _shared_dir(tmp_path_factory) -> Path:
    """A directory every test worker of this session shares: the
    session's base temp under xdist, this process's own otherwise."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / "gloo_shapes"
    root.mkdir(exist_ok=True)
    return root


class _Group:
    """One gloo group of ``P`` processes running every shape: spawned by
    the session's first test worker to need it, whose results every
    worker reads (a worker that runs one shape's case must not start its
    own groups)."""

    def __init__(self, root: Path, P: int):
        self.outs = [root / f"shapes{P}_{r}.pkl" for r in range(P)]
        self.logs = [root / f"shapes{P}_{r}.log" for r in range(P)]
        self.done = root / f"shapes{P}.done"
        self.procs = []
        self._res = None
        try:
            os.close(os.open(root / f"shapes{P}.owner",
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        except FileExistsError:
            return          # another worker spawned it
        port = _free_port()
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        blob = pickle.dumps(({**SHAPES, **ERROR_SHAPES}, FEEDS)).hex()
        for r in range(P):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", WORKER, str(ROOT), str(port), str(P),
                     str(r), str(self.outs[r]), blob],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(root)))

    def results(self):
        if self._res is None:
            if self.procs:
                for p in self.procs:
                    try:
                        p.wait(timeout=240)
                    except subprocess.TimeoutExpired:
                        p.kill()
                self.done.touch()
            else:
                deadline = time.time() + 300
                while not self.done.exists():
                    assert time.time() < deadline, "the spawning worker never finished"
                    time.sleep(0.5)
            self._res = {r: (pickle.loads(out.read_bytes()) if out.exists()
                             else log.read_text()[-3000:])
                         for r, (out, log) in enumerate(zip(self.outs, self.logs))}
        for r, v in self._res.items():
            assert isinstance(v, dict), f"process {r} failed:\n{v}"
        return self._res


@pytest.fixture(scope="session")
def groups(tmp_path_factory):
    started = {P: _Group(_shared_dir(tmp_path_factory), P) for P in PROCESSES}
    yield started
    for g in started.values():
        for p in g.procs:
            if p.poll() is None:
                p.kill()


_REF = {}


class _Errors(logging.Handler):
    """The processing errors a package logs."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.seen = []

    def emit(self, record):
        self.seen.append(record.getMessage()[:300])


def _ref_run(name):
    """The reference's single-process rows of a shape, by output stream,
    and the errors it logged (made while the groups run)."""
    if name not in _REF:
        import siddhi_tpu
        import torch_helpers

        app, _queries, streams, feed = {**SHAPES, **ERROR_SHAPES}[name]
        errors = _Errors()
        log = logging.getLogger("siddhi_tpu")
        log.addHandler(errors)
        try:
            m = siddhi_tpu.SiddhiManager()
            rt = m.create_siddhi_app_runtime(app)
            sinks = {s: torch_helpers.make_collector(siddhi_tpu.StreamCallback)
                     for s in streams}
            for s, c in sinks.items():
                rt.add_callback(s, c)
            torch_helpers.drive(rt, *FEEDS[feed])
            m.shutdown()
        finally:
            log.removeHandler(errors)
        _REF[name] = ({s: c.rows for s, c in sinks.items()}, errors.seen)
    return _REF[name]


def _ref_rows(name):
    return _ref_run(name)[0]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_shape_split_across_processes_equals_the_reference(groups, shape):
    """The shape at 2 and at 4 processes: every process's rows equal the
    reference's single-process rows."""
    want = _ref_rows(shape)
    assert any(want.values()), shape
    expect = SPLITS.get(shape, ["input"] * len(SHAPES[shape][1]))
    for P, g in groups.items():
        for r, res in g.results().items():
            splits, got, errors = res[shape]
            assert splits == expect, (P, r, splits)
            assert not errors, (P, r, errors)
            for stream, rows in want.items():
                assert_rows_match(got[stream], rows)


def test_unservable_duration_drops_triggers_on_every_process(groups):
    """A join asking the aggregation for a duration it does not keep
    drops its trigger rows on every process, each logging the reference's
    error as often as the reference does (once: one trigger send), while
    its partition-mate's rows equal the reference's."""
    name = "join_aggregation_unserved"
    want, ref_errors = _ref_run(name)
    assert len(ref_errors) == 1 and "dropping trigger events" in ref_errors[0], ref_errors
    assert want["Out"] and not want["OutD"]
    for P, g in groups.items():
        for r, res in g.results().items():
            splits, got, errors = res[name]
            assert splits == SPLITS[name], (P, r, splits)
            assert errors == ref_errors, (P, r, errors)
            for stream, rows in want.items():
                assert_rows_match(got[stream], rows)


# the shapes ROADMAP A.11 split last: a partitioned join against an
# incremental aggregation, and an unpartitioned pattern's group by
AGG_SIDE_APP = """
define stream L (k string, v double);
define stream R (k string, v double);
define aggregation Agg from R select k, sum(v) as t group by k aggregate every sec ... min;
partition with (k of L)
begin
  @info(name = 'q')
  from L#window.length(4) join Agg on L.k == Agg.k within 0L, 100000L per 'seconds'
  select L.k as k, Agg.t as t insert into Out;
end;
"""


@pytest.mark.parametrize("app,query,mode", [
    (AGG_SIDE_APP, "q", "input"),
    (PATTERN_GROUP_APP.replace("partition with (k of A, k of B)\nbegin\n", "").replace(
        "end;\n", ""), "q", None),
], ids=["join_aggregation_side", "pattern_unpartitioned_group_by"])
def test_a11_shapes_split(app, query, mode):
    """The split mode of the last two shapes A.11 named: at the input
    (the aggregation whole on every process), and none (the unpartitioned
    pattern whole on every process)."""
    import siddhi_tpu_torch
    from siddhi_tpu_torch.parallel.mesh import _split_mode

    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    q = m.create_siddhi_app_runtime(app).query_runtimes[query]
    try:
        assert _split_mode(q) == mode
    finally:
        m.shutdown()


def test_children_import_neither_jax_nor_the_reference(groups):
    # last: the shapes' references run while the groups do
    for P, g in groups.items():
        for r, res in g.results().items():
            assert res["imports_clean"], (P, r)
