"""createSet / unionSet / sizeOfSet, set-valued (OBJECT) attributes: the
port against the JAX package.

The shapes of tests/test_sets.py whose windows are ported (length, not
lengthBatch) run through both packages with the same sends and compare
every output row exactly: a singleton set travels as its element's int64
code, a unionSet output as its live count plus ``[B, H]`` '#set'/'#setm'
element snapshots, and both decode to ``frozenset``s. Failures the
reference raises (arity, a non-object argument, a multi-element set whose
snapshot a window dropped) raise in the port too."""

import numpy as np
import pytest
import torch_helpers  # noqa: F401 — one torch thread per test process
from torch_helpers import assert_rows_match, make_collector


def run(pkg, app, stream, sends, outs=("OutStream",), query_callback=None):
    if pkg == "jax":
        import siddhi_tpu as mod
        from siddhi_tpu.core.query.callback import QueryCallback

        m = mod.SiddhiManager()
    else:
        import siddhi_tpu_torch as mod
        from siddhi_tpu_torch import QueryCallback

        m = mod.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(app)
    cols = {o: make_collector(mod.StreamCallback) for o in outs}
    for o, c in cols.items():
        rt.add_callback(o, c)
    calls = []
    if query_callback is not None:
        class QC(QueryCallback):
            def receive(self, ts, in_events, remove_events):
                calls.append([tuple(e.data) for e in in_events or []])

        rt.add_callback(query_callback, QC())
    h = rt.get_input_handler(stream)
    for ts, data in sends:
        h.send(ts, list(data))
    m.shutdown()
    return {o: c.rows for o, c in cols.items()}, calls


def both(app, stream, sends, **kw):
    want, wcalls = run("jax", app, stream, sends, **kw)
    got, gcalls = run("torch", app, stream, sends, **kw)
    for o in want:
        assert_rows_match(got[o], want[o])
    assert gcalls == wcalls
    return got, gcalls


def data(rows):
    return [d for _ts, d, _e in rows]


def test_createset_singleton_decodes_to_set():
    got, _ = both("""
        define stream S (sym string, v int);
        from S select createSet(sym) as s, v insert into OutStream;
    """, "S", [(1, ["IBM", 1]), (2, ["WSO2", 2]), (3, [None, 3])])
    assert data(got["OutStream"]) == [
        (frozenset({"IBM"}), 1), (frozenset({"WSO2"}), 2), (None, 3)]


@pytest.mark.parametrize("typ,val", [
    ("int", 7), ("long", 9), ("double", 2.5), ("double", -0.0),
    ("float", 1.25), ("bool", True),
])
def test_createset_primitive_types(typ, val):
    got, _ = both(f"""
        define stream S (x {typ});
        from S select createSet(x) as s insert into OutStream;
    """, "S", [(1, [val])])
    assert data(got["OutStream"]) == [(frozenset({val}),)]


def test_unionset_over_window_adds_and_removes():
    got, _ = both("""
        define stream S (sym string);
        from S#window.length(2)
        select unionSet(createSet(sym)) as syms insert into OutStream;
    """, "S", [(i, [s]) for i, s in enumerate("ABACBBD")])
    assert data(got["OutStream"])[3] == (frozenset({"A", "C"}),)


def test_unionset_chain_over_length_window_and_sizeofset():
    """createSet -> stream -> window unionSet -> stream -> sizeOfSet (the
    chain of tests/test_sets.py over a length window), every stream
    compared; element metadata crosses streams."""
    rng = np.random.default_rng(4)
    syms = [f"s{int(i)}" for i in rng.integers(0, 5, 40)]
    got, _ = both("""
        define stream Stock (sym string, price double);
        from Stock select createSet(sym) as initialSet insert into InitStream;
        from InitStream#window.length(6)
        select unionSet(initialSet) as distinctSyms insert into DistinctStream;
        from DistinctStream select sizeOfSet(distinctSyms) as n
        insert into OutStream;
    """, "Stock", [(i, [s, float(i)]) for i, s in enumerate(syms)],
        outs=("OutStream", "DistinctStream", "InitStream"))
    sizes = [d[0] for d in data(got["OutStream"])]
    assert sizes == [len(d[0]) for d in data(got["DistinctStream"])]


def test_unionset_group_by_keeps_groups_separate():
    got, _ = both("""
        define stream S (user string, sym string);
        from S#window.length(4)
        select user, unionSet(createSet(sym)) as syms
        group by user insert into OutStream;
    """, "S", [(i, [u, s]) for i, (u, s) in enumerate(
        [("u1", "A"), ("u2", "B"), ("u1", "C"), ("u2", "B"), ("u1", "A"),
         ("u1", "D"), ("u2", "E")])])
    assert data(got["OutStream"])[2] == ("u1", frozenset({"A", "C"}))


def test_sizeofset_on_singleton():
    got, _ = both("""
        define stream S (sym string);
        from S select createSet(sym) as s insert into Mid;
        from Mid select sizeOfSet(s) as n insert into OutStream;
    """, "S", [(1, ["A"]), (2, [None])])
    assert data(got["OutStream"]) == [(1,), (0,)]


def test_unionset_survives_event_republish_path():
    """A query callback decodes the multi-element sets to Events; the next
    query still reads them through the stream's metadata."""
    got, calls = both("""
        define stream S (sym string);
        define stream Mid (u object);
        @info(name='q1')
        from S#window.length(4)
        select unionSet(createSet(sym)) as u insert into Mid;
        from Mid select sizeOfSet(u) as n insert into OutStream;
    """, "S", [(1, ["A"]), (2, ["B"]), (3, ["C"])], query_callback="q1")
    assert data(got["OutStream"]) == [(1,), (2,), (3,)]
    assert calls[-1] == [(frozenset({"A", "B", "C"}),)]


def test_consumer_defined_before_producer_sees_metadata():
    got, _ = both("""
        define stream S (sym string);
        define stream Mid (u object);
        from Mid select sizeOfSet(u) as n insert into OutStream;
        from S#window.length(4)
        select unionSet(createSet(sym)) as u insert into Mid;
    """, "S", [(1, ["A"]), (2, ["B"]), (3, ["A"])])
    assert data(got["OutStream"]) == [(1,), (2,), (2,)]


def test_unionset_of_a_unionset_folds_its_elements():
    """A unionSet over an upstream unionSet's output (no window between)
    folds the '#set' snapshot element by element."""
    got, _ = both("""
        define stream S (user string, sym string);
        from S#window.length(3)
        select user, unionSet(createSet(sym)) as u group by user
        insert into Mid;
        from Mid select unionSet(u) as uu insert into OutStream;
    """, "S", [(i, [u, s]) for i, (u, s) in enumerate(
        [("a", "x"), ("b", "y"), ("a", "z"), ("b", "x"), ("a", "w")])])
    assert data(got["OutStream"])[-1][0] >= frozenset({"w", "x"})


@pytest.mark.parametrize("app", [
    # createSet takes one argument (FunctionTestCase.testFunctionQuery9)
    "define stream S (sym string, d long); "
    "from S select createSet(sym, d) as s insert into OutStream;",
    # sizeOfSet needs an object attribute
    "define stream S (v int); from S select sizeOfSet(v) as n insert into OutStream;",
    # unionSet needs an object argument
    "define stream S (sym string); from S#window.length(2) "
    "select unionSet(sym) as s insert into OutStream;",
], ids=["createset_arity", "sizeofset_object", "unionset_object"])
def test_invalid_set_apps_fail_in_both(app):
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            import siddhi_tpu as mod

            m = mod.SiddhiManager()
        else:
            import siddhi_tpu_torch as mod

            m = mod.SiddhiManager(device="cpu")
        with pytest.raises(Exception):
            m.create_siddhi_app_runtime(app)
        m.shutdown()


def test_unionset_after_window_drops_snapshot_rejected():
    app = """
        define stream S (sym string);
        define stream Mid (u object);
        from S select unionSet(createSet(sym)) as u insert into Mid;
        from Mid#window.length(2)
        select unionSet(u) as uu insert into OutStream;
    """
    for pkg in ("jax", "torch"):
        with pytest.raises(Exception, match="snapshot|companions|multi"):
            run(pkg, app, "S", [(1, ["A"])])
