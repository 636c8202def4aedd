"""Rows that leave a partition for a stream outside it, on the CPU.

A partitioned query re-publishes its rows into a stream outside the
partition. The port strips the partition's own key columns (``__pk__``,
``__gk__``) at that re-publish, so a window over the outer stream buffers
the stream's attributes only. The reference keeps them: the window there
raises ``KeyError: '__pk__'``, and its junction logs the error and drops
the batch. That is fault R10 of the reference (ROADMAP §C), and this
file's departure from it.

- Two shapes under ``@app:playback``, held against a sequential
  plain-Python oracle written here (exact; floats to rtol 1e-12):
  the fuzzer's seed 1, case 32 (its events; a partitioned
  ``externalTime`` with ``max``/``avg`` by group, into a ``length(4)``
  outside), and a
  partitioned ``length(2)`` sum into a ``lengthBatch(3)`` with a group by
  outside. Behind the generic ``length`` window the reference gives none
  of the rows and logs the ``KeyError``; the ``lengthBatch`` shape it
  gives.
- The fuzzer counts the processing errors each run's junctions log:
  case 32 runs with none; a planted failing UDF makes every run log, the
  case report it (``CaseResult.logged_errors``) and
  ``python -m siddhi_tpu_torch.fuzz`` exit non-zero.
"""

import dataclasses
import logging

import numpy as np
import pytest

from torch_helpers import (
    FLOAT_RTOL,
    assert_rows_match,
    make_collector,
    release_jax_programs,  # noqa: F401 — autouse fixture: frees JAX programs
)

from siddhi_tpu_torch.fuzz.generator import CaseGenerator

# the fuzzer's seed 1, case 32: its events, and its first two queries
# (the C.11 shape) without q0's filter, which passes none of the events
CASE = CaseGenerator(seed=1, events_per_case=60, max_queries=4).case(32)

EXTERNAL_APP = """@app:playback
define stream In0 (ts long, sym string, v0 long, v1 double);
partition with (sym of In0)
begin
  @info(name='q0') from In0#window.externalTime(ts, 2000 millisec)
  select sym, max(v1) as agg0, avg(v1) as agg1 group by sym insert into Out0;
end;
@info(name='q1') from Out0#window.length(4) select sym, agg1 insert into Out1;
"""

BATCH_APP = """@app:playback
define stream In0 (ts long, sym string, v0 long, v1 double);
partition with (sym of In0)
begin
  @info(name='q0') from In0#window.length(2)
  select sym, sum(v1) as s insert into Mid;
end;
@info(name='q1') from Mid#window.lengthBatch(3)
select sym, count() as c, sum(s) as t group by sym insert into Out1;
"""


def _events():
    return [(ts, row) for _stream, ts, row in CASE.events]


def _oracle_external(events):
    """q0 then q1, one event at a time: a key's externalTime window holds
    its rows whose ``ts`` lies within 2000 ms of its newest; ``max`` is
    the key's largest value so far (the sliding max never drops a value
    in either package: R2), ``avg`` over the window. q1 passes Out0's
    rows on (a length window emits its current rows)."""
    live, top, out = {}, {}, []
    for ts, (t, sym, _v0, v1) in events:
        rows = [r for r in live.get(sym, []) if r[0] + 2000 > t] + [(t, v1)]
        live[sym] = rows
        top[sym] = max(top.get(sym, v1), v1)
        out.append((ts, (sym, sum(v for _t, v in rows) / len(rows)), False))
    return out


def _oracle_batch(events):
    """q0: each row's key's sum over its last two rows (Mid); q1: every
    third Mid row flushes the batch, one row a group (the group's last in
    the batch, in the order of those last rows) with the group's count
    and sum over the batch."""
    last, mid, out = {}, [], []
    for ts, (_t, sym, _v0, v1) in events:
        last[sym] = (last.get(sym, []) + [v1])[-2:]
        mid.append((ts, sym, sum(last[sym])))
        if len(mid) == 3:
            groups = {}
            for i, (ts_i, s, v) in enumerate(mid):
                c, t, _ = groups.get(s, (0, 0.0, 0))
                groups[s] = (c + 1, t + v, i)
            for s, (c, t, i) in sorted(groups.items(), key=lambda g: g[1][2]):
                out.append((mid[i][0], (s, c, t), False))
            mid = []
    return out


def _run(pkg, app, events):
    if pkg == "jax":
        import siddhi_tpu as P

        m = P.SiddhiManager()
    else:
        import siddhi_tpu_torch as P

        m = P.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(app)
    c = make_collector(P.StreamCallback)
    rt.add_callback("Out1", c)
    h = rt.get_input_handler("In0")
    for ts, row in events:
        h.send(ts, list(row))
    m.shutdown()
    return c.rows


@pytest.mark.parametrize("app,oracle,ref_drops", [
    (EXTERNAL_APP, _oracle_external, True),
    (BATCH_APP, _oracle_batch, False)],
    ids=["external_time_into_length", "length_into_length_batch"])
def test_rows_leaving_a_partition_feed_an_outer_window(caplog, app, oracle, ref_drops):
    events = _events()
    want = oracle(events)
    assert len(want) >= 3
    with caplog.at_level(logging.ERROR):
        got = _run("torch", app, events)
    assert not [r for r in caplog.records if "__pk__" in r.getMessage()]
    assert_rows_match(got, want, rtol=FLOAT_RTOL)
    caplog.clear()
    with caplog.at_level(logging.ERROR):
        ref = _run("jax", app, events)
    if ref_drops:
        # behind the generic length window the reference drops every such
        # batch (R10): its junction logs the KeyError and Out1 stays empty
        assert ref == []
        assert any("__pk__" in r.getMessage() for r in caplog.records)
    else:
        # its batch window buffers the key columns it was first given, so
        # the reference gives this shape's rows
        assert_rows_match(ref, want, rtol=FLOAT_RTOL)


def test_fuzz_case_32_runs_without_logged_errors():
    """Case 32's first two queries, q0 without its filter (as above),
    through the fuzzer's matrix: before the repair every run logged the
    ``KeyError`` and dropped Out1's batches alike."""
    from siddhi_tpu_torch.fuzz.runner import run_case

    q0, q1 = CASE.queries[:2]
    case = dataclasses.replace(CASE, queries=[dataclasses.replace(q0, filter=None), q1])
    res = run_case(case, max_combos=2, device="cpu")
    assert res.logged_errors == [], res.logged_errors
    assert not res.divergences and not res.census_findings
    assert res.baseline["Out1"]


class _Boom:
    """A UDF whose every call fails: each query step that reaches it
    raises, and the junction logs the error and drops the batch."""

    @staticmethod
    def return_type(*_types):
        from siddhi_tpu_torch.query_api.definitions import AttrType

        return AttrType.DOUBLE

    @staticmethod
    def apply(xp, *args):
        raise RuntimeError("planted UDF failure")


def _planted_case(monkeypatch):
    """Case 32's pass-through query with the failing UDF in its selection,
    and every manager the fuzzer opens knowing the UDF."""
    import siddhi_tpu_torch.core.manager as manager
    from siddhi_tpu_torch.extension import ScalarFunction

    boom = type("Boom", (ScalarFunction,), dict(vars(_Boom)))
    init = manager.SiddhiManager.__init__

    def init_with_udf(self, *a, **k):
        init(self, *a, **k)
        self.set_extension("function:custom:boom", boom)

    monkeypatch.setattr(manager.SiddhiManager, "__init__", init_with_udf)
    q3 = CASE.queries[3]
    q3 = dataclasses.replace(q3, select_items=q3.select_items + [["custom:boom(v1)", "b"]])
    return dataclasses.replace(CASE, queries=[q3])


def test_fuzz_reports_logged_errors_of_a_planted_udf(monkeypatch):
    from siddhi_tpu_torch.fuzz.runner import run_case

    case = _planted_case(monkeypatch)
    res = run_case(case, max_combos=2, device="cpu")
    # every run fails alike, so the differ sees no divergence
    assert not res.divergences
    assert len(res.logged_errors) == len(res.combos_run) >= 2
    assert all("planted UDF failure" in line for line in res.logged_errors)


def test_fuzz_main_exits_nonzero_on_logged_errors(monkeypatch, tmp_path):
    import json

    from siddhi_tpu_torch.fuzz import __main__ as fuzz_main
    from siddhi_tpu_torch.fuzz import generator

    case = _planted_case(monkeypatch)
    monkeypatch.setattr(generator.CaseGenerator, "case", lambda self, i: case)
    report = tmp_path / "report.json"
    rc = fuzz_main.main(["--device", "cpu", "--cases", "1", "--max-combos", "1",
                         "--report", str(report)])
    assert rc == 1
    rep = json.loads(report.read_text())
    assert not rep["divergences"] and not rep["census_findings"]
    assert rep["logged_errors"] and np.all(
        ["planted UDF failure" in line for line in rep["logged_errors"]])
