"""The port stands alone: ``siddhi_tpu_torch``, ``chip_smoke.py`` and
``distinct_bench.py`` import neither ``jax`` nor the JAX package ``siddhi_tpu``, and its entry points
choose the CUDA card unless told otherwise."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch_helpers  # noqa: F401 — one torch thread per test process

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "siddhi_tpu")


def _port_sources():
    return sorted((ROOT / "siddhi_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "distinct_bench.py"]


def _imported_roots(path):
    """Top-level module names every import statement in ``path`` names."""
    roots = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.extend(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.append(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_and_runs_with_jax_unimportable():
    """With ``jax`` made unimportable, the port still imports (the distinct
    scan, extension and query-callback modules, the pipeline, the ingest
    pool, the wire format, transports and retry included), builds the
    routed slice's app, a distinctCount/unionSet/extension app, an
    @Async/@OnError app with a sink fed by a wire frame through the pool at
    depth 4, and a range partition with @purge, an inner stream, a
    partition-local stream and keyed time, session and sort windows on the
    CPU, and a playback app with a join (the partitioned engine's step), a
    table fed by ``update or insert into`` and probed by ``in`` and a
    join, a named window, an ``every`` trigger and on-demand finds, and
    answers them; the serving tier, the REST service, statistics, the WAL,
    metrics export, fan-out fusion (its planner, group, graph and reason
    codes), the step instrument, the program cache, the cost registry and
    the step inventory and the utils import too (the routed step shares
    through the cache), and a sharded aggregation under
    ``@app:statistics`` with a WAL runs and is scraped."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["siddhi_tpu"] = None
sys.path.insert(0, {str(ROOT)!r})
import siddhi_tpu_torch
from siddhi_tpu_torch import QueryCallback, SiddhiManager, StreamCallback
from siddhi_tpu_torch.core.query.callback import QueryCallback as QC2
from siddhi_tpu_torch.extension import ScalarFunction
from siddhi_tpu_torch.ops.distinct import distinct_scan, distinct_scan_plain
from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh
from siddhi_tpu_torch.query_api.definitions import AttrType
from siddhi_tpu_torch.core.util.statistics import StatisticsManager
from siddhi_tpu_torch.observability import export
from siddhi_tpu_torch.resilience import IngestWAL
from siddhi_tpu_torch.service import SiddhiRestService
from siddhi_tpu_torch.serving import ShardedIncrementalAggregation
from siddhi_tpu_torch.serving.cluster_gather import gather_query_rows
from siddhi_tpu_torch.utils.docgen import generate_docs
from siddhi_tpu_torch.utils.event_printer import print_events
from siddhi_tpu_torch.core.eligibility import code_of
from siddhi_tpu_torch.core.plan.fanout_plan import plan_fanout_groups
from siddhi_tpu_torch.core.query.fused_fanout import FusedFanoutRuntime
from siddhi_tpu_torch.core.query.step_graph import StepGraph
from siddhi_tpu_torch.core.util import program_cache
from siddhi_tpu_torch.observability import costmodel
from siddhi_tpu_torch.observability.telemetry import InstrumentedJit
from siddhi_tpu_torch.analysis import step_registry
assert all(step_registry.resolve(n) for n in step_registry.JIT_STEP_BUILDERS)
APP = '''
define stream StockStream (symbol string, price float, volume long);
partition with (symbol of StockStream)
begin
  @info(name = 'bench')
  from StockStream#window.length(2)
  select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
  insert into OutStream;
end;
'''
class C(StreamCallback):
    def __init__(self): self.rows = []
    def receive(self, events): self.rows.extend(e.data for e in events)
m = SiddhiManager(device="cpu")
rt = m.create_siddhi_app_runtime(APP)
c = C(); rt.add_callback("OutStream", c)
device_route_query_step(rt.query_runtimes["bench"], make_mesh(4), rows_per_shard=64)
h = rt.get_input_handler("StockStream")
for i, (s, p, v) in enumerate([("A", 1.0, 1), ("B", 2.0, 2), ("A", 3.0, 3), ("A", 5.0, 4)]):
    h.send(i, [s, p, v])
assert isinstance(rt.query_runtimes["bench"]._step, InstrumentedJit)
assert any(e["family"] == "device_routed" for e in program_cache.cache().snapshot()["entries"])
m.shutdown()
assert c.rows == [["A", 1.0, 1], ["B", 2.0, 2], ["A", 2.0, 4], ["A", 4.0, 7]], c.rows
class Q(QueryCallback):
    def __init__(self): self.rows = []
    def receive(self, ts, ins, rems): self.rows.extend(e.data for e in ins or [])
class Twice(ScalarFunction):
    return_type = AttrType.LONG
    @staticmethod
    def apply(xp, a): return xp.where(a > 0, a * 2, a)
m = SiddhiManager(device="cpu")
m.set_extension("function:twice", Twice)
rt = m.create_siddhi_app_runtime('''
define stream S (sym string, v long);
@info(name = 'q') from S#window.length(2)
select distinctCount(sym) as d, unionSet(createSet(v)) as u, twice(v) as t
insert into O;''')
q = Q(); rt.add_callback("q", q)
h = rt.get_input_handler("S")
for s, v in [("a", 1), ("a", 2), ("b", 2)]:
    h.send([s, v])
m.shutdown()
assert q.rows == [[1, frozenset({{1}}), 2], [1, frozenset({{1, 2}}), 4],
                  [2, frozenset({{2}}), 4]], q.rows
import numpy as np
from siddhi_tpu_torch import InMemoryConfigManager
from siddhi_tpu_torch.core.query.completion import CompletionPump
from siddhi_tpu_torch.core.stream.input.pack_pool import IngestPackPool
from siddhi_tpu_torch.core.stream.input.wire import DecoderRegistry, WireEncoder, decode_frame
from siddhi_tpu_torch.extension import InMemoryBroker
from siddhi_tpu_torch.resilience import RetryPolicy, stat_count
m = SiddhiManager(device="cpu")
m.set_config_manager(InMemoryConfigManager({{"siddhi_tpu.pipeline_depth": "4",
                                            "siddhi_tpu.ingest_pool": "2",
                                            "siddhi_tpu.ingest_split": "256"}}))
rt = m.create_siddhi_app_runtime('''
@Async(buffer.size='8') @OnError(action='stream')
define stream S (sym string, v long);
@sink(type='inMemory', topic='iso')
define stream O (sym string, t long);
@info(name = 'q') from S#window.length(4) select sym, sum(v) as t group by sym
insert into O;''')
got = []
class Sub(InMemoryBroker.Subscriber):
    topic = "iso"
    def on_message(self, payload): got.append(payload)
InMemoryBroker.subscribe(Sub())
h = rt.get_input_handler("S")
d, ts = decode_frame(WireEncoder().encode({{"sym": np.array(["a", "b"] * 300, dtype=object),
                                           "v": np.ones(600, np.int64)}}),
                     rt.junctions["S"].definition, rt.app_context.string_dictionary,
                     DecoderRegistry())
h.send_columns(d)
m.shutdown()
assert len(got) == 600 and got[-1] == ["b", 2], got[-1:]
assert rt.app_context.completion_pump.metas > 0
rt = SiddhiManager(device="cpu").create_siddhi_app_runtime('''
@app:playback define stream S (sym string, v long);
@purge(enable='true', interval='1 sec', idle.period='1 hour')
partition with (v < 5 as 'lo' or v >= 3 as 'hi' of S)
begin
  from S#window.time(100 millisec) select sym, v insert into #Mid;
  from #Mid#window.session(50 millisec) select sym, count() as n insert into P;
  @info(name = 'q') from P#window.sort(2, n) select sym, n insert into O;
end;''')
c = C(); rt.add_callback("O", c)
h = rt.get_input_handler("S")
for i, (s, v) in enumerate([("a", 1), ("b", 4), ("c", 9)]):
    h.send(1000 + i, [s, v])
rt.shutdown()
assert c.rows == [["a", 1], ["b", 2], ["b", 1], ["c", 2]], c.rows
rt = SiddhiManager(device="cpu").create_siddhi_app_runtime('''
@app:playback define stream L (k string, v long); define stream R (k string, v long);
define trigger T at every 1 sec;
@primaryKey('k') define table Tb (k string, v long);
define window W (k string, v long) length(2);
from R select k, v update or insert into Tb on Tb.k == k;
from L select k, v insert into W;
@info(name = 'j') from L#window.length(8) join R#window.time(1 sec) on L.k == R.k
select L.k as k, L.v as lv, R.v as rv insert into J;
from L join Tb on L.k == Tb.k select L.k as k, Tb.v as tv insert into TJ;
from L[(k == Tb.k) in Tb] select k, v insert into IN;
from T select triggered_time as t insert into TT;''')
outs = {{}}
for s in ("J", "TJ", "IN", "TT"):
    outs[s] = C(); rt.add_callback(s, outs[s])
hl, hr = rt.get_input_handler("L"), rt.get_input_handler("R")
hr.send(1000, ["a", 5]); hl.send(1500, ["a", 1]); hl.send(2600, ["b", 2])
found = rt.query("from Tb on k == 'a' select k, v")
wrows = rt.query("from W select k, v")
rt.shutdown()
assert outs["J"].rows == [["a", 1, 5]], outs["J"].rows
assert outs["TJ"].rows == [["a", 5]], outs["TJ"].rows
assert outs["TT"].rows == [[2000]], outs["TT"].rows
assert [e.data for e in found] == [["a", 5]] and len(wrows) == 2
sm = SiddhiManager(device="cpu")
sm.set_config_manager(siddhi_tpu_torch.InMemoryConfigManager({{"siddhi_tpu.agg_shards": "2"}}))
srt = sm.create_siddhi_app_runtime("@app:statistics('true') define stream S (k string, v long); "
    "define aggregation A from S select k, sum(v) as t group by k aggregate every sec ... min;")
srt.enable_wal()
srt.get_input_handler("S").send(["a", 1])
assert isinstance(srt.aggregations["A"], ShardedIncrementalAggregation)
assert "siddhi_aggregation_shards" in export.prometheus_text(sm)
assert srt.statistics()["throughput"]["S"]["events"] == 1
sm.shutdown()
assert "jax" not in {{k for k, v in sys.modules.items() if v is not None}}
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr[-2000:]


def test_manager_without_device_chooses_cuda():
    from siddhi_tpu_torch import SiddhiManager

    if torch.cuda.is_available():
        assert SiddhiManager().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            SiddhiManager()


def test_unported_constructs_are_named_not_skipped():
    """What the port still refuses raises naming its ROADMAP item: a join
    routed over a mesh (A.9), the device profiler trace (A.10).
    Incremental aggregations, joins against them and the serving tier's
    sharded aggregation stores (``siddhi_tpu.agg_shards`` > 1, ported in
    A.7(c)) build."""
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.ops.expressions import CompileError
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh
    from siddhi_tpu_torch.serving import ShardedIncrementalAggregation

    agg = ("define stream S (a int, b long); define aggregation Agg from S "
           "select a, sum(b) as t group by a aggregate every sec ... min; ")
    join = (agg + "define stream R (a int); from R join Agg on R.a == Agg.a "
            "within 0L, 10L per 'seconds' select R.a as a, Agg.t as t insert into O;")
    m = SiddhiManager(device="cpu")
    m.create_siddhi_app_runtime(join)       # builds: A.7 (a) is ported
    sharded = SiddhiManager(device="cpu")
    sharded.set_config_manager(InMemoryConfigManager({"siddhi_tpu.agg_shards": "4"}))
    srt = sharded.create_siddhi_app_runtime(agg)
    assert isinstance(srt.aggregations["Agg"], ShardedIncrementalAggregation)
    assert srt.aggregations["Agg"].n_shards == 4
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.10"):
        srt.start_trace("trace")
    rt = m.create_siddhi_app_runtime(
        "define stream L (k string, v long); define stream R (k string, v long); "
        "partition with (k of L, k of R) begin @info(name='j') "
        "from L#window.length(4) join R#window.length(4) on L.v > R.v "
        "select L.k as k, R.v as rv insert into O; end;")
    with pytest.raises(CompileError, match="join queries.*A.9"):
        device_route_query_step(rt.query_runtimes["j"], make_mesh(2))
    m.shutdown()
    sharded.shutdown()


def test_nfa_init_state_needs_a_device():
    """``NFAStage.init_state`` takes the device from its caller: no CPU
    default to fall back on."""
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(
        "define stream A (k string, v double); define stream B (k string, v double); "
        "@info(name='q') from every e1=A -> e2=B select e1.k as k insert into O;")
    stage = rt.query_runtimes["q"].stage
    with pytest.raises(TypeError, match="device"):
        stage.init_state(1)
    assert stage.init_state(1, torch.device("cpu"))["active"].device.type == "cpu"
    m.shutdown()
