"""``@app:statistics`` on the port (``core/util/statistics.py``, the
junction and query-runtime hooks, ``SiddhiAppRuntime.statistics``), on the
CPU.

The scenarios of ``tests/test_statistics.py`` drive the port through the
module's own apps and checks (``torch_helpers.port_corpus``; those that
take pytest's ``capsys`` get it); ``test_profiler_trace_roundtrip`` stays
out with ``start_trace`` (ROADMAP A.10), whose refusal is checked here.
The same app and feed give equal statistics in both packages.
"""

import inspect

import numpy as np
import pytest
import torch

from torch_helpers import port_corpus, release_jax_programs  # noqa: F401 — autouse fixture

MOD, _PLAIN = port_corpus("test_statistics")
# test_profiler_trace_roundtrip: the device profiler trace, ROADMAP A.10
LEFT_OUT = ("test_profiler_trace_roundtrip",)
SCENARIOS = sorted(
    k for k, v in vars(MOD).items()
    if k.startswith("test_") and inspect.isfunction(v) and k not in LEFT_OUT
    and set(inspect.signature(v).parameters) <= {"capsys"})


def test_every_scenario_is_collected():
    """The module holds 7 scenarios; all but the profiler trace run."""
    assert len(SCENARIOS) == 6, SCENARIOS


@pytest.mark.parametrize("name", SCENARIOS)
def test_statistics_corpus_on_port(name, capsys):
    fn = getattr(MOD, name)
    if inspect.signature(fn).parameters:
        fn(capsys)
    else:
        fn()


def test_profiler_trace_is_refused_by_name():
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(
        "define stream S (v int); from S[v > 0] select v insert into O;")
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.10"):
        rt.start_trace("trace")
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.10"):
        rt.stop_trace()
    m.shutdown()


APP = """
@app:name('statApp')
@app:statistics(level='detail')
@app:playback
define stream S (sym string, v long);
define table T (sym string, v long);
@info(name = 'q')
from S#window.length(8) select sym, sum(v) as total group by sym insert into Out;
from S[v > 5] select sym, v insert into T;
"""


def _run(pkg):
    if pkg == "jax":
        from siddhi_tpu import SiddhiManager
    else:
        import functools

        from siddhi_tpu_torch import SiddhiManager

        SiddhiManager = functools.partial(SiddhiManager, device="cpu")
    m = SiddhiManager()
    rt = m.create_siddhi_app_runtime(APP)
    h = rt.get_input_handler("S")
    rng = np.random.default_rng(5)
    for b in range(3):
        n = 16
        h.send_columns({"sym": np.array([f"K{i}" for i in rng.integers(0, 4, n)], object),
                        "v": rng.integers(0, 10, n).astype(np.int64)},
                       timestamps=np.arange(n, dtype=np.int64) + 100 * b)
    h.send(1000, ["K9", 7])
    rep = rt.statistics()
    m.shutdown()
    return rep


def test_statistics_equal_the_reference():
    """Throughput events and batches of every stream, the queries' latency
    batch counts, the trackers' names and the DETAIL probes' names equal
    the reference's on the same app and feed."""
    got, want = _run("torch"), _run("jax")
    assert got["level"] == want["level"] == "detail"
    assert got["throughput"].keys() == want["throughput"].keys()
    for name, t in want["throughput"].items():
        assert (got["throughput"][name]["events"], got["throughput"][name]["batches"]) \
            == (t["events"], t["batches"]), name
    # a junction's tracker takes one sample per completed delivery: the
    # reference fuses the stream's two queries into one dispatch (fan-out
    # fusion, ROADMAP A.8), the port completes each query on its own
    queries = {n: t["batches"] for n, t in want["latency"].items()
               if not n.startswith("junction.")}
    assert {n: t["batches"] for n, t in got["latency"].items()
            if not n.startswith("junction.")} == queries
    assert {n for n in got["latency"] if n.startswith("junction.")} \
        == {n for n in want["latency"] if n.startswith("junction.")}
    assert set(got["memory_bytes"]) == set(want["memory_bytes"])
    assert got["memory_bytes"]["query.q"] > 0
    assert got["memory_total_bytes"] > 0


def test_pytree_nbytes_sums_state_tensors():
    from siddhi_tpu_torch.core.util.statistics import pytree_nbytes

    state = {"a": torch.zeros(4, dtype=torch.float64),
             "b": (torch.zeros(3, dtype=torch.int32), [np.zeros(2, np.int8)]),
             "c": None, "d": 7}
    assert pytree_nbytes(state) == 32 + 12 + 2
