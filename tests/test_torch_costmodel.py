"""The port's step-program cost registry (``observability/costmodel.py``),
on the CPU: the two cost scenarios of ``tests/test_journey.py`` as tensor
counterparts (that module's other scenarios need the batch-journey
profiler and the fault injector, ROADMAP A.10, so it cannot run through
``torch_helpers.port_corpus``), with the same apps, sends and checks. The
records' numbers are the port's own dispatch counts (an eager run under a
``TorchDispatchMode``), not XLA's.
"""

import pytest

from torch_helpers import make_collector, release_jax_programs  # noqa: F401 — autouse fixture

APP = """
define stream S (sym string, v long);
@info(name='pq')
from S#window.length(8)
  select sym, sum(v) as total group by sym
  insert into Out;
"""

FOUR_Q = """
define stream S (sym string, v long);
@info(name='q1') from S#window.length(8) select sym, sum(v) as t group by sym insert into O1;
@info(name='q2') from S#window.length(8) select sym, sum(v) as t group by sym insert into O2;
@info(name='q3') from S#window.length(8) select sym, sum(v) as t group by sym insert into O3;
@info(name='q4') from S#window.length(8) select sym, sum(v) as t group by sym insert into O4;
"""


@pytest.fixture(autouse=True)
def _costs_off():
    yield
    from siddhi_tpu_torch.observability import costmodel

    costmodel.disable(force=True)


def _manager(depth, extra=None, pkg="torch"):
    if pkg == "jax":
        from siddhi_tpu import SiddhiManager
        from siddhi_tpu.core.util.config import InMemoryConfigManager

        m = SiddhiManager()
    else:
        from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

        m = SiddhiManager(device="cpu")
    cfg = {"siddhi_tpu.pipeline_depth": str(depth)}
    cfg.update(extra or {})
    m.set_config_manager(InMemoryConfigManager(cfg))
    return m


def test_programs_duplicate_clusters_agree_with_fanout_gauge():
    """On a 4-identical-query app the registry's duplicate-fingerprint
    clusters tell the same story as the fan-out dedup's
    ``unique_programs`` gauge: 4 step programs, one computation."""
    from siddhi_tpu_torch.observability import costmodel

    m1 = _manager(2)
    rt1 = m1.create_siddhi_app_runtime(FOUR_Q)
    rt1.get_input_handler("S").send(["A", 1])
    unique = int(rt1.app_context.telemetry.read_gauges()["fanout.S.unique_programs"])
    assert unique == 1
    m1.shutdown()

    costmodel.registry().reset()
    costmodel.enable()
    m2 = _manager(2, {"siddhi_tpu.fuse_fanout": "false"})
    rt2 = m2.create_siddhi_app_runtime(FOUR_Q)
    rt2.get_input_handler("S").send(["A", 1])
    snap = costmodel.registry().snapshot()
    step_keys = [p["key"] for p in snap["programs"] if p["key"].startswith("query.q")]
    assert len(step_keys) == 4
    step_clusters = [c for c in snap["clusters"]
                     if any(k.startswith("query.q") for k in c["keys"])]
    assert len(step_clusters) == unique == 1
    assert step_clusters[0]["size"] == 4
    assert step_clusters[0]["duplicates"] == 3
    # the three later queries share the first one's program, and copy its record
    shared = sorted(p["key"] for p in snap["programs"] if p["shared"])
    assert shared == ["query.q2.step", "query.q3.step", "query.q4.step"]
    m2.shutdown()


def test_cost_capture_records_analysis_fields():
    from siddhi_tpu_torch import StreamCallback
    from siddhi_tpu_torch.observability import costmodel

    costmodel.registry().reset()
    costmodel.enable()
    m = _manager(2)
    rt = m.create_siddhi_app_runtime(APP)
    rt.get_input_handler("S").send(["A", 1])
    recs = {p.key: p for p in costmodel.registry().programs()}
    rec = recs["query.pq.step"]
    assert rec.error is None
    assert rec.flops > 0
    assert rec.bytes_accessed > 0
    assert rec.arg_bytes > 0
    assert len(rec.fingerprint) == 16
    # the capture ran on a clone of the state: the step's own state is as
    # the first call left it, and the next send sums on from it
    out = make_collector(StreamCallback)
    rt.add_callback("Out", out)
    rt.get_input_handler("S").send(["A", 2])
    assert [r[1] for r in out.rows] == [("A", 3)]
    # the gauges render on /metrics
    from siddhi_tpu_torch.observability.export import prometheus_text

    text = prometheus_text(m)
    assert 'siddhi_jit_cost_flops{key="query.pq.step"}' in text
    m.shutdown()
