"""Fan-out fusion on the port (``core/plan/fanout_plan.py``,
``core/query/fused_fanout.py``, ``core/query/step_graph.py``), on the CPU.

- Every scenario of the reference's ``tests/test_fanout.py`` drives the
  port through the module's own apps and asserts (``port_corpus``):
  groups and their members, clusters and shared state objects, the
  dispatch and meta-pull counters, the gauges and the ``jit`` records,
  overflow attribution, release and dissolve, and snapshots across a
  fusion-config change.
- The fan-out scenarios of ``tests/test_join_engine.py`` and the fused
  group riding the pipeline of ``tests/test_pipeline.py``, each through
  both packages.
- The slice as a whole: the FO app of ``chip_smoke.py`` (four copies of
  the global flagship, the twin, D1 and a filter, seven siblings on one
  stream) at a small width, fused in the port == fused in the reference
  == unfused in the port (ints, strings, timestamps and order exact,
  floats to rtol 1e-12), at pipeline depths 1 and 4; and with the clock
  handed to the step as a 0-d tensor, as a captured step takes it.
- Revisions across packages and fusion: the reference's unfused revision
  restores into the port's fused app and the port's fused revision into
  the reference's unfused app; both continue to the reference's rows.
- The capturability declarations: FO's group is capturable, a group
  holding a join side or an externalTime window is not; on the CPU no
  group runs as a graph. A card test holds graph == eager (skips here).
- Routing a fused member over a mesh releases it from its group.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

from torch_helpers import (
    assert_rows_match, make_collector, port_corpus, release_jax_programs)  # noqa: F401

MOD, SCENARIOS = port_corpus("test_fanout")
SNAPSHOT_SCENARIO = "test_snapshot_restores_across_fusion_config_change"
JOIN_MOD = port_corpus("test_join_engine")[0]
PIPE_MOD = port_corpus("test_pipeline", unported=("siddhi_tpu.resilience.faults",))[0]
JOIN_SCENARIOS = ("test_join_side_fuses_on_shared_junction_bit_identical",
                  "test_fused_join_side_overflow_names_partition_knob",
                  "test_self_join_sides_do_not_fuse")
PIPE_SCENARIO = "test_fused_group_rides_pipeline_and_drains_in_member_order"


def test_every_fanout_scenario_is_collected():
    """12 plain scenarios and one parametrized one (3 cases): none left
    out."""
    assert len(SCENARIOS) == 12, SCENARIOS
    params = sorted(k for k, v in vars(MOD).items()
                    if k.startswith("test_") and inspect.isfunction(v)
                    and inspect.signature(v).parameters)
    assert params == [SNAPSHOT_SCENARIO]


@pytest.mark.parametrize("name", SCENARIOS)
def test_fanout_corpus_on_port(name):
    getattr(MOD, name)()


@pytest.mark.parametrize("before,after", [(True, False), (False, True), (True, True)])
def test_fanout_snapshot_corpus_on_port(before, after):
    getattr(MOD, SNAPSHOT_SCENARIO)(before, after)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("name", JOIN_SCENARIOS)
def test_join_engine_fanout_scenarios(name, pkg):
    # the reference's own module (it imports the JAX package, so only here)
    mod = importlib.import_module("test_join_engine") if pkg == "jax" else JOIN_MOD
    getattr(mod, name)()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fused_group_rides_pipeline(pkg):
    mod = importlib.import_module("test_pipeline") if pkg == "jax" else PIPE_MOD
    getattr(mod, PIPE_SCENARIO)()


# ------------------------------------------------------------- the slice

W = 64
FO_QUERIES = [
    ("q0", "O0", "from StockStream#window.length({W}) select symbol, avg(price) as "
                 "avgPrice, sum(volume) as totalVolume group by symbol"),
    ("q4", "O4", "from StockStream[price > 0.0]#window.length(16) select symbol, "
                 "avg(price) as avgPrice, sum(volume) as totalVolume, count() as n, "
                 "min(price) as minPrice group by symbol"),
    ("q5", "O5", "from StockStream#window.length({W}) select symbol, "
                 "distinctCount(volume) as volumes, avg(price) as avgPrice, "
                 "ifThenElse(price > 50.0, 'high', 'low') as band, "
                 "maximum(cast(volume, 'double'), 500.0) as volFloor, "
                 "eventTimestamp() as ts group by symbol"),
    ("q6", "O6", "from StockStream[volume > 500] select symbol, price * volume as notional"),
]


def fo_app(W=W, extra=""):
    """chip_smoke.py's FO app at window ``W``: q0-q3 the global flagship
    (into O0-O3), q4 the twin, q5 D1, q6 a filter."""
    q0 = FO_QUERIES[0]
    queries = [(f"q{i}", f"O{i}", q0[2]) for i in range(4)] + FO_QUERIES[1:]
    body = "".join(f"@info(name='{n}') {text.format(W=W)} insert into {out};\n"
                   for n, out, text in queries)
    return ("define stream StockStream (symbol string, price float, volume long);\n"
            + body + extra)


FO_OUTS = [f"O{i}" for i in range(7)]


def fo_feed(seed=11, n_batches=3, batch=96, n_symbols=12):
    rng = np.random.default_rng(seed)
    syms = np.array([f"S{i}" for i in range(n_symbols)], dtype=object)
    feed, ts = [], 1000
    for _ in range(n_batches):
        feed.append(({"symbol": syms[rng.integers(0, n_symbols, batch)],
                      "price": (rng.random(batch) * 100.0 - 15.0).astype(np.float32),
                      "volume": rng.integers(1, 1000, batch)},
                     np.arange(ts, ts + batch, dtype=np.int64)))
        ts += batch
    return feed


def _pkg(pkg):
    if pkg == "jax":
        import siddhi_tpu
        from siddhi_tpu.core.util.config import InMemoryConfigManager

        return siddhi_tpu, siddhi_tpu.SiddhiManager, InMemoryConfigManager
    import functools

    import siddhi_tpu_torch
    from siddhi_tpu_torch import InMemoryConfigManager

    return (siddhi_tpu_torch,
            functools.partial(siddhi_tpu_torch.SiddhiManager, device="cpu"),
            InMemoryConfigManager)


def _build(pkg, app, outs, config=()):
    mod, manager, cfg = _pkg(pkg)
    m = manager()
    m.set_config_manager(cfg({"siddhi_tpu.pipeline_depth": "1", **dict(config)}))
    rt = m.create_siddhi_app_runtime(app)
    cols = {s: make_collector(mod.StreamCallback) for s in outs}
    for s, c in cols.items():
        rt.add_callback(s, c)
    return m, rt, cols


def run(pkg, app, feed, outs, stream="StockStream", config=(), on_build=None):
    """{out stream: rows} of ``app`` over ``feed`` (column batches)."""
    m, rt, cols = _build(pkg, app, outs, config)
    if on_build is not None:
        on_build(rt)
    h = rt.get_input_handler(stream)
    for batch, ts in feed:
        h.send_columns(batch, timestamps=ts)
    m.shutdown()
    return {s: c.rows for s, c in cols.items()}


def assert_outs_match(got, want):
    assert got.keys() == want.keys()
    for s in want:
        assert_rows_match(got[s], want[s])


def test_fo_group_shape_and_capturability():
    m, rt, _c = _build("torch", fo_app(), FO_OUTS)
    (group,) = rt.fused_fanout_groups
    assert [q.name for q in group.members] == [f"q{i}" for i in range(7)]
    assert group.capturable()
    assert not group.captured            # the CPU runs the step eagerly
    h = rt.get_input_handler("StockStream")
    for batch, ts in fo_feed(n_batches=1):
        h.send_columns(batch, timestamps=ts)
    assert [len(c) for c in group._clusters] == [4, 1, 1, 1]
    q = rt.query_runtimes
    assert q["q0"]._state is q["q3"]._state and q["q0"]._state is not q["q4"]._state
    gauges = rt.app_context.telemetry.read_gauges()
    assert (gauges["fanout.StockStream.group_size"],
            gauges["fanout.StockStream.unique_programs"],
            gauges["fanout.StockStream.captured"]) == (7, 4, 0)
    m.shutdown()


def test_fo_fused_equals_reference_and_unfused():
    feed = fo_feed()
    want = run("jax", fo_app(), feed, FO_OUTS)
    assert all(want[s] for s in FO_OUTS)
    assert_outs_match(run("torch", fo_app(), feed, FO_OUTS), want)
    assert_outs_match(run("torch", fo_app(), feed, FO_OUTS,
                          config={"siddhi_tpu.fuse_fanout": "false"}), want)
    # q0-q3 are one computation: their rows are equal
    assert want["O0"] == want["O1"] == want["O2"] == want["O3"]


def test_fo_depth_four_equals_depth_one():
    feed = fo_feed(seed=12, n_batches=5, batch=64)
    one = run("torch", fo_app(), feed, FO_OUTS)
    four = run("torch", fo_app(), feed, FO_OUTS, config={"siddhi_tpu.pipeline_depth": "4"})
    assert_outs_match(four, one)


EXPIRED_APP = """@app:playback
define stream StockStream (symbol string, price float, volume long);
@info(name='x0') from StockStream#window.length(8)
  select symbol, price, currentTimeMillis() as t insert all events into X0;
@info(name='x1') from StockStream#window.length(8)
  select symbol, sum(volume) as v group by symbol insert all events into X1;
"""


def test_clock_as_a_tensor_gives_the_same_rows():
    """A captured step takes the clock as a 0-d tensor (a Python int would
    be baked into the graph): the group's step fed that way stamps the
    same EXPIRED timestamps, as does currentTimeMillis()."""
    feed = fo_feed(seed=13, n_batches=4, batch=6)

    def tensor_clock(rt):
        (group,) = rt.fused_fanout_groups
        build = group._build_step

        def build_with_tensor_clock(*args):
            build(*args)
            step = group._step
            group._step = lambda states, cols, now: step(
                states, cols, torch.tensor(now, dtype=torch.int64))

        group._build_step = build_with_tensor_clock

    base = run("torch", EXPIRED_APP, feed, ["X0", "X1"],
               config={"siddhi_tpu.fuse_fanout": "false"})
    got = run("torch", EXPIRED_APP, feed, ["X0", "X1"], on_build=tensor_clock)
    assert_outs_match(got, base)
    # 24 arrivals into a window of 8: 16 EXPIRED rows, stamped with the clock
    # (the re-publish flips them to CURRENT)
    assert len(base["X0"]) == 24 + 16


# ------------------------------------------------------ capture declarations

def _group_of(app, stream):
    m, rt, _c = _build("torch", app, [])
    groups = [g for g in rt.fused_fanout_groups if g.stream_id == stream]
    return m, groups


def test_join_side_and_external_time_groups_are_not_capturable():
    m, (group,) = _group_of(JOIN_MOD.FANOUT_APP, "L")
    assert [q.name for q in group.members] == ["f0", "jq.left", "f1"]
    assert not group.capturable() and not group.captured
    m.shutdown()
    app = """
    define stream S (symbol string, v long, ts long);
    @info(name='a') from S select symbol, v insert into A;
    @info(name='b') from S#window.externalTime(ts, 1 sec)
      select symbol, sum(v) as sv insert into B;
    """
    m, (group,) = _group_of(app, "S")
    assert len(group.members) == 2
    assert group.members[0].capturable() and not group.members[1].capturable()
    assert not group.capturable()
    m.shutdown()


def test_host_functions_are_not_capturable():
    app = """
    define stream S (symbol string, v long);
    @info(name='a') from S[v > 0] select symbol, v insert into A;
    @info(name='b') from S[log('v', v)] select symbol, v insert into B;
    """
    m, (group,) = _group_of(app, "S")
    a, b = group.members
    assert a.capturable() and not b.capturable()
    m.shutdown()


@pytest.mark.cuda
def test_cuda_captured_group_equals_eager():
    """On the card: FO runs as one graph replay a batch, and equals the
    same app fused but eager and unfused, at depths 1 and 4; so does the
    app whose EXPIRED rows carry the clock (a tensor the replay reads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the group is captured as a CUDA graph")
    import siddhi_tpu_torch
    from siddhi_tpu_torch import InMemoryConfigManager

    def card(app, outs, feed, cfg, eager=False):
        m = siddhi_tpu_torch.SiddhiManager(device="cuda")
        m.set_config_manager(InMemoryConfigManager(cfg))
        rt = m.create_siddhi_app_runtime(app)
        group = rt.fused_fanout_groups[0] if rt.fused_fanout_groups else None
        if group is not None:
            if eager:
                group.captured = False
            else:
                assert group.captured
        cols = {s: make_collector(siddhi_tpu_torch.StreamCallback) for s in outs}
        for s, c in cols.items():
            rt.add_callback(s, c)
        h = rt.get_input_handler("StockStream")
        for batch, ts in feed:
            h.send_columns(batch, timestamps=ts)
        if group is not None and not eager:
            # the batch that captures runs eagerly; every other one replays
            assert group.graph.captures == 1
            assert group.graph.replays == len(feed) - group.graph.captures
        m.shutdown()
        return {s: c.rows for s, c in cols.items()}

    cases = [(fo_app(), FO_OUTS, fo_feed(seed=14, n_batches=6, batch=512, n_symbols=40)),
             (EXPIRED_APP, ["X0", "X1"], fo_feed(seed=13, n_batches=4, batch=6))]
    for app, outs, feed in cases:
        eager = card(app, outs, feed, {"siddhi_tpu.pipeline_depth": "1"}, eager=True)
        for depth in ("1", "4"):
            assert_outs_match(card(app, outs, feed, {"siddhi_tpu.pipeline_depth": depth}),
                              eager)
        assert_outs_match(card(app, outs, feed, {"siddhi_tpu.fuse_fanout": "false"}),
                          eager)


# ----------------------------------------------------- revisions, routing

SNAP_APP = """@app:name('fanrev')
define stream StockStream (symbol string, price float, volume long);
@info(name='r0') from StockStream#window.length(16)
  select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
  group by symbol insert into O0;
@info(name='r1') from StockStream#window.length(16)
  select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
  group by symbol insert into O1;
@info(name='r2') from StockStream[volume > 300]#window.length(8)
  select symbol, max(price) as hi group by symbol insert into O2;
"""
SNAP_OUTS = ["O0", "O1", "O2"]


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_revision_restores_across_packages_and_fusion(src, dst):
    """The reference's UNFUSED revision restores into the port's FUSED app
    and the port's fused revision into the reference's unfused app: the
    remaining batches give the reference's rows."""
    feed = fo_feed(seed=15, n_batches=4, batch=48)
    want = run("jax", SNAP_APP, feed, SNAP_OUTS,
               config={"siddhi_tpu.fuse_fanout": "false"})
    fused = {"jax": "false", "torch": "true"}
    m1, rt1, c1 = _build(src, SNAP_APP, SNAP_OUTS, {"siddhi_tpu.fuse_fanout": fused[src]})
    h = rt1.get_input_handler("StockStream")
    for batch, ts in feed[:2]:
        h.send_columns(batch, timestamps=ts)
    blob = rt1.snapshot()
    head = {s: list(c.rows) for s, c in c1.items()}
    m1.shutdown()
    m2, rt2, c2 = _build(dst, SNAP_APP, SNAP_OUTS, {"siddhi_tpu.fuse_fanout": fused[dst]})
    assert bool(rt2.fused_fanout_groups) == (dst == "torch")
    rt2.restore(blob)
    h = rt2.get_input_handler("StockStream")
    for batch, ts in feed[2:]:
        h.send_columns(batch, timestamps=ts)
    if dst == "torch":
        (group,) = rt2.fused_fanout_groups
        assert [len(c) for c in group._clusters] == [2, 1]
    m2.shutdown()
    assert_outs_match({s: head[s] + c2[s].rows for s in SNAP_OUTS}, want)


def test_routing_a_member_releases_it_from_its_group():
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    app = """
    define stream S (symbol string, v long);
    @info(name='g') from S select symbol, sum(v) as sv group by symbol insert into G;
    @info(name='p') from S select symbol, v + 1 as v insert into P;
    """
    feed = [({"symbol": np.array(["A", "B", "A", "C"] * 4, dtype=object),
              "v": np.arange(16, dtype=np.int64)}, np.arange(16, dtype=np.int64) + 100 * i)
            for i in range(3)]
    want = run("torch", app, feed, ["G", "P"], stream="S",
               config={"siddhi_tpu.fuse_fanout": "false"})

    def route(rt):
        (group,) = rt.fused_fanout_groups
        device_route_query_step(rt.query_runtimes["g"], make_mesh(2), rows_per_shard=64)
        assert group.members == [] and rt.query_runtimes["g"]._fanout_group is None
        assert rt.query_runtimes["g"] in rt.junctions["S"].receivers

    got = run("torch", app, feed, ["G", "P"], stream="S", on_build=route)
    assert_outs_match(got, want)


def _fanout_lines(pkg):
    if pkg == "jax":
        from siddhi_tpu.observability.export import prometheus_text
    else:
        from siddhi_tpu_torch.observability.export import prometheus_text
    app = ("@app:name('fanmetrics')\n"
           "define stream S (symbol string, v long);\n"
           "@info(name='m0') from S select symbol, v insert into A;\n"
           "@info(name='m1') from S[v > 1] select symbol, v insert into B;\n")
    m, rt, _c = _build(pkg, app, [])
    h = rt.get_input_handler("S")
    for i in range(3):
        h.send(100 + i, ["IBM", i])
    text = prometheus_text(m, "fanmetrics")
    m.shutdown()
    return text.splitlines()


def test_metrics_render_the_fanout_and_jit_families():
    """``/metrics`` renders the group's counters and group-size gauge as
    the reference's families, with the reference's values, and the
    step's compile and hit records as ``siddhi_jit_*`` (a compile per
    build, a hit per member and batch)."""
    got, want = _fanout_lines("torch"), _fanout_lines("jax")
    fam = ("siddhi_fanout_group_size{", "siddhi_fanout_dispatches_total{",
           "siddhi_fanout_meta_pulls_total{")
    pick = sorted(line for line in got if line.startswith(fam))
    assert pick == sorted(line for line in want if line.startswith(fam))
    assert len(pick) == 3 and 'stream="S"' in pick[0]
    jit = {line.split("}")[0] + "}": line.rsplit(" ", 1)[1] for line in got
           if line.startswith("siddhi_jit_") and 'key="fanout.S.step"' in line}
    assert jit['siddhi_jit_compiles_total{app="fanmetrics",key="fanout.S.step"}'] == "1"
    assert jit['siddhi_jit_cache_hits_total{app="fanmetrics",key="fanout.S.step"}'] == "6"


CODES_APP = """
define stream S (symbol string, v long, ts long);
define stream R (symbol string, w long);
@info(name='plain') from S[v > 0] select symbol, v insert into A;
@info(name='timed') from S#window.time(1 sec) select symbol, sum(v) as sv insert into B;
@info(name='sorted') from S#window.sort(3, v) select symbol, v insert into C;
@info(name='logged') from S#log('x') select symbol, v insert into D;
@info(name='joined') from S#window.length(4) join R#window.length(4)
  on S.symbol == R.symbol select S.symbol as symbol, v, w insert into E;
@info(name='self') from R#window.length(2) as a join R#window.length(2) as b
  on a.symbol == b.symbol select a.symbol as symbol, b.w as w insert into F;
partition with (symbol of S)
begin
  @info(name='keyed') from S#window.length(2) select symbol, v insert into G;
end;
"""


def _codes(pkg, config):
    if pkg == "jax":
        from siddhi_tpu.core.eligibility import code_of
        from siddhi_tpu.core.plan.fanout_plan import fusion_ineligibility
    else:
        from siddhi_tpu_torch.core.eligibility import code_of
        from siddhi_tpu_torch.core.plan.fanout_plan import fusion_ineligibility
    m, rt, _c = _build(pkg, CODES_APP, [], config)
    out = {}
    for name, q in sorted(rt.query_runtimes.items()):
        for key, r in sorted(getattr(q, "_proxies", {"": q}).items()):
            out[f"{name}{'.' + key if key else ''}"] = code_of(fusion_ineligibility(r)).value
    m.shutdown()
    return out


@pytest.mark.parametrize("engine", ["device", "legacy"])
def test_fusion_reason_codes_equal_the_reference(engine):
    """Each receiver's fusion eligibility code (core/eligibility.py), the
    join sides' included, equals the reference's."""
    config = {"siddhi_tpu.join_engine": engine, "siddhi_tpu.fuse_fanout": "false"}
    got = _codes("torch", config)
    assert got == _codes("jax", config)
    assert got["plain"] == "ELIGIBLE" and got["timed"] == "SCHEDULER_WINDOW"
    assert got["joined.left"] == ("ELIGIBLE" if engine == "device" else "NO_DEVICE_ENGINE")
