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
    ``@app:statistics`` with a WAL runs and is scraped; the observability
    tier (the span tracer, batch journeys, device instruments, the device
    trace), the fault injector and the debugger import, and a span trace
    and a journey of a send are recorded; the autopilot, the cluster
    fabric (router, egress, protocol, worker) and ``PeerMonitor`` import,
    and a dry-run tick runs; the semantic fuzzer and the sanitizer import,
    and one fuzz case runs its matrix under ``SIDDHI_TPU_SANITIZE=1``
    (the pull guard, the watchdog and the checked locks armed)."""
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
from siddhi_tpu_torch.observability import device_trace, instruments, journey, tracing
from siddhi_tpu_torch.resilience.faults import FaultInjector
from siddhi_tpu_torch.core.debugger import SiddhiDebugger
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
tracing.TRACER.start()
journey.enable()
for i, (s, p, v) in enumerate([("A", 1.0, 1), ("B", 2.0, 2), ("A", 3.0, 3), ("A", 5.0, 4)]):
    h.send(i, [s, p, v])
names = {{e["name"] for e in tracing.TRACER.stop()["traceEvents"]}}
assert {{"junction.dispatch", "query.step"}} <= names, names
assert journey.ring() and "shard_rows" in rt.query_runtimes["bench"]._instr_last
journey.disable(force=True)
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
from siddhi_tpu_torch.resilience import AppSupervisor, OverloadManager
from siddhi_tpu_torch.resilience.overload import FairScheduler, ensure_memory_budget
om = SiddhiManager(device="cpu")
om.set_config_manager(InMemoryConfigManager({{"siddhi_tpu.quota_queue_depth": "2",
                                             "siddhi_tpu.shed_policy": "shed_newest",
                                             "siddhi_tpu.quota_memory_mb": "64"}}))
ort = om.create_siddhi_app_runtime('''@app:name('iso_ov') @Async(buffer.size='8')
define stream S (sym string, v long);
@info(name = 'q') from S select sym, sum(v) as t group by sym insert into O;''')
oc = C(); ort.add_callback("O", oc)
sup = ort.supervise(interval_s=0.05)
assert isinstance(sup, AppSupervisor)
assert OverloadManager.instance().control_of("iso_ov") is ort.app_context.overload
octl = ort.app_context.overload
for i in range(20):
    ort.get_input_handler("S").send([f"k{{i}}", i])
om.shutdown()
ctl_gone = OverloadManager.instance().control_of("iso_ov") is None
assert ctl_gone and len(oc.rows) + octl.shed_events == 20, (ctl_gone, len(oc.rows))
from siddhi_tpu_torch.autopilot import ACTUATORS, AutopilotController
from siddhi_tpu_torch.cluster import ClusterRuntime, OrderedEgress
from siddhi_tpu_torch.cluster import protocol, worker
from siddhi_tpu_torch.resilience import PeerMonitor
am = SiddhiManager(device="cpu")
art = am.create_siddhi_app_runtime("@app:name('iso_ap') define stream S (sym string, v long); "
                                   "from S select sym, v insert into O;")
art.start()
art.enable_autopilot(mode="dry_run", interval_s=3600)
AutopilotController.instance().tick("iso_ap", now=1.0)
assert AutopilotController.instance().report("iso_ap")["apps"]["iso_ap"]["ticks"] == 1
am.shutdown()
import os
import siddhi_tpu_torch.fuzz
from siddhi_tpu_torch.analysis import locks, sanitize
from siddhi_tpu_torch.fuzz import CaseGenerator, run_case
import logging
logged = []
class Errors(logging.Handler):
    def emit(self, record): logged.append(record.getMessage()[:500])
logging.getLogger().addHandler(Errors(logging.ERROR))
os.environ["SIDDHI_TPU_SANITIZE"] = "1"
sanitize.enable()
acq = locks.acquisitions()
res = run_case(CaseGenerator(0).case(1), max_combos=3, device="cpu")
assert res.pairs_diffed >= 3 and not res.divergences, [d.summary() for _c, d in res.divergences]
assert not res.census_findings and locks.acquisitions() > acq, res.census_findings
assert not logged and sum(map(len, res.baseline.values())) > 0, logged[:1]
del os.environ["SIDDHI_TPU_SANITIZE"]
assert not any(k == "jax" or k.startswith(("jax.", "siddhi_tpu.")) or k == "siddhi_tpu"
               for k, v in sys.modules.items() if v is not None)
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr[-2000:]


def test_worker_entry_point_loads_neither_jax_nor_the_reference():
    """``python -m siddhi_tpu_torch.cluster.worker --help`` in a process
    where ``jax`` and ``siddhi_tpu`` cannot be imported: it prints its
    usage, naming ``--device``, and exits 0."""
    code = f"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["siddhi_tpu"] = None
sys.path.insert(0, {str(ROOT)!r})
sys.argv = ["worker", "--help"]
try:
    runpy.run_module("siddhi_tpu_torch.cluster.worker", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert not any(k == "jax" or k.startswith(("jax.", "siddhi_tpu.")) or k == "siddhi_tpu"
               for k, v in sys.modules.items() if v is not None)
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.rstrip().endswith("OK"), out.stderr[-2000:]
    assert "--device" in out.stdout


def test_cluster_worker_on_an_absent_card_fails_its_deploy_naming_the_device():
    """A fabric asked for workers on ``cuda`` where no card is visible: the
    worker process comes up, its deploy fails naming the device, and
    ``deploy`` raises; nothing runs on the CPU instead."""
    from siddhi_tpu_torch.cluster import ClusterRuntime

    if torch.cuda.is_available():
        pytest.skip("shows the refusal where no CUDA device is visible")

    cluster = ClusterRuntime(n_workers=1, heartbeat_s=0.2, device="cuda")
    try:
        cluster.wait_ready(60)
        assert cluster.status()["device"] == "cuda"
        with pytest.raises(RuntimeError, match=r"failed to deploy 'c'.*device cuda"):
            cluster.deploy("@app:name('c') define stream S (v long); "
                           "from S select v insert into O;", sinks=["O"], timeout=60)
        assert "c" not in cluster.apps
    finally:
        cluster.shutdown()


def test_manager_without_device_chooses_cuda():
    from siddhi_tpu_torch import SiddhiManager

    if torch.cuda.is_available():
        assert SiddhiManager().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            SiddhiManager()


def test_unported_constructs_are_named_not_skipped(monkeypatch):
    """What the port refused before runs: ``shard_exchange pallas_ring``
    across processes (B.10) is accepted (the mesh's process group is the
    next check) and, on CPU tensors, takes its plain version; a
    partitioned keyed-length join routes over a mesh, the supervisor takes
    its peer recovery and peer monitor, the fault injector drops and
    restores a peer (A.9), as do the REST service's cluster fabric (A.10
    d), incremental aggregations, joins against them and the serving
    tier's sharded aggregation stores (``siddhi_tpu.agg_shards`` > 1,
    A.7(c))."""
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.parallel import distributed
    from siddhi_tpu_torch.parallel.mesh import Mesh, device_route_query_step, make_mesh
    from siddhi_tpu_torch.resilience import PeerRecovery
    from siddhi_tpu_torch.resilience.supervisor import PeerMonitor
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
    from siddhi_tpu_torch.resilience import FaultInjector
    from siddhi_tpu_torch.service import SiddhiRestService

    monitor = PeerMonitor()
    sup = srt.supervise(interval_s=60.0, peer_monitor=monitor,
                        peer_recovery=PeerRecovery(lambda: None))
    assert sup.peer_monitor is monitor and sup.peer_recovery is not None
    sup.stop()
    assert SiddhiRestService(sharded, cluster=object()).cluster is not None
    faults = FaultInjector()
    faults.drop_peer()
    with pytest.raises(distributed.ClusterPeerError, match="injected peer death"):
        distributed.guarded_pull(torch.zeros(2), 5.0, what="probe")
    faults.restore_peer()
    assert distributed.guarded_pull(torch.ones(2), 5.0).tolist() == [1.0, 1.0]
    rt = m.create_siddhi_app_runtime(
        "define stream L (k string, v long); define stream R (k string, v long); "
        "partition with (k of L, k of R) begin @info(name='j') "
        "from L#window.length(4) join R#window.length(4) on L.v > R.v "
        "select L.k as k, R.v as rv insert into O; end;")
    q = rt.query_runtimes["j"]
    with pytest.raises(RuntimeError, match="needs the process group"):
        device_route_query_step(q, Mesh(4, process_count=2), exchange="pallas_ring")
    from siddhi_tpu_torch.ops import exchange

    taken = []
    monkeypatch.setattr(exchange, "process_exchange_plain",
                        lambda sent, n, L, p, *a: taken.append((n, L, p)) or sent)
    bufs = [torch.arange(16, dtype=torch.int64).view(2, 8)]
    got = exchange.peer_exchange_cols(bufs, exchange.PeerExchange(4, 2, 2, 1))
    assert got[0] is bufs[0]
    assert taken == [(4, 2, 1)] and exchange.peer_exchange_cols.launches == 0
    device_route_query_step(q, make_mesh(2))
    assert q._route_layout.n == 2
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
