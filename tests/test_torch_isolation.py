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
    routed slice's app, a distinctCount/unionSet/extension app and an
    @Async/@OnError app with a sink fed by a wire frame through the pool at
    depth 4 on the CPU, and answers them."""
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
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.ops.expressions import CompileError

    m = SiddhiManager(device="cpu")
    for app, what in [
        ("define stream S (a int); define table T (a int); "
         "from S select a insert into T;", "tables"),
        ("define stream S (a int); from S#window.time(1 sec) select a "
         "insert into O;", "time window"),
        ("define stream S (a int); from S select a output every 5 events "
         "insert into O;", "rate limiting"),
    ]:
        with pytest.raises(CompileError, match=what):
            m.create_siddhi_app_runtime(app)
