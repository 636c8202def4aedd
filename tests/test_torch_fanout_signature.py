"""Identical-program dedup on the port: ``QueryRuntime.program_signature``
against the reference's jaxpr equality, on the CPU.

A corpus of query pairs on one stream, each pair in one app with a
filter sibling after it (so the group holds a cluster of one or two and
the sibling's): identical (one target), the output target alone
differing, a filter constant, a window length, an output attribute name,
the group key, and a value table's H (set on one query before the first
batch) differing; and the identical pair again under
``@app:precision('fast')``. The same feed goes through both packages.
The port's clusters (``[len(c) for c in group._clusters]``) equal the
reference's in every case, member for member, so the port never clusters
what the reference keeps apart; the rows of both packages agree (ints,
strings and order exact, floats to rtol 1e-12).
"""

import numpy as np
import pytest

from torch_helpers import assert_rows_match, make_collector, release_jax_programs  # noqa: F401

GROUPED = "from S#window.length(4) select symbol, sum(v) as sv group by symbol"
DISTINCT = ("from S#window.length(8) select symbol, distinctCount(v) as dv "
            "group by symbol")
SIBLING = "@info(name='z') from S[v > 50] select symbol, v insert into Z;\n"

# name: (query a, target a, query b, target b, app head, H of b or None, clusters)
PAIRS = {
    "identical": (GROUPED, "A", GROUPED, "A", "", None, [2, 1]),
    "target_alone": (GROUPED, "A", GROUPED, "B", "", None, [2, 1]),
    "filter_constant": ("from S[v > 2] select symbol, v", "A",
                        "from S[v > 3] select symbol, v", "B", "", None, [1, 1, 1]),
    "window_length": (GROUPED, "A", GROUPED.replace("length(4)", "length(5)"), "B",
                      "", None, [1, 1, 1]),
    "output_name": (GROUPED, "A", GROUPED.replace("as sv", "as total"), "B",
                    "", None, [1, 1, 1]),
    "group_key": (GROUPED, "A", GROUPED.replace("group by symbol", "group by k2"), "B",
                  "", None, [1, 1, 1]),
    "precision_fast": (GROUPED, "A", GROUPED, "B", "@app:precision('fast')\n", None,
                       [2, 1]),
    "distinct_h": (DISTINCT, "A", DISTINCT, "B", "", 16, [1, 1, 1]),
}


def _app(case):
    qa, ta, qb, tb, head, _h, _want = PAIRS[case]
    return (head + "define stream S (symbol string, k2 string, v long);\n"
            f"@info(name='a') {qa} insert into {ta};\n"
            f"@info(name='b') {qb} insert into {tb};\n" + SIBLING)


def _feed(seed=3, n_batches=3, batch=24):
    rng = np.random.default_rng(seed)
    syms = np.array(["IBM", "WSO2", "GOOG", "ORCL"], dtype=object)
    out, t = [], 100
    for _ in range(n_batches):
        out.append(({"symbol": syms[rng.integers(0, 4, batch)],
                     "k2": syms[rng.integers(0, 2, batch)],
                     "v": rng.integers(0, 100, batch)},
                    np.arange(t, t + batch, dtype=np.int64)))
        t += batch
    return out


def _run(pkg, case):
    if pkg == "jax":
        import siddhi_tpu as mod

        m = mod.SiddhiManager()
    else:
        import siddhi_tpu_torch as mod

        m = mod.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(_app(case))
    h_b = PAIRS[case][5]
    if h_b is not None:
        for spec in rt.query_runtimes["b"].selector_plan.specs:
            spec.distinct_capacity = h_b
    outs = sorted({PAIRS[case][1], PAIRS[case][3], "Z"})
    cols = {s: make_collector(mod.StreamCallback) for s in outs}
    for s, c in cols.items():
        rt.add_callback(s, c)
    h = rt.get_input_handler("S")
    for batch, ts in _feed():
        h.send_columns(batch, timestamps=ts)
    (group,) = rt.fused_fanout_groups
    clusters = [[group.members[i].name for i in c] for c in group._clusters]
    m.shutdown()
    return clusters, {s: c.rows for s, c in cols.items()}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_port_clusters_equal_the_reference(case):
    want_clusters, want_rows = _run("jax", case)
    got_clusters, got_rows = _run("torch", case)
    assert [len(c) for c in want_clusters] == PAIRS[case][6]
    assert got_clusters == want_clusters
    for s in want_rows:
        assert_rows_match(got_rows[s], want_rows[s])


def test_signature_ignores_name_and_target_only():
    """The signature renders the query without its name and output
    target; anything the step reads (here the output event type) tells
    two queries apart, and an unrenderable part gives None."""
    import siddhi_tpu_torch

    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(
        "define stream S (symbol string, k2 string, v long);\n"
        f"@info(name='a') {GROUPED} insert into A;\n"
        f"@info(name='b') {GROUPED} insert into B;\n"
        f"@info(name='c') {GROUPED} insert expired events into C;\n")
    q = rt.query_runtimes
    assert q["a"].program_signature() == q["b"].program_signature() is not None
    assert q["a"].program_signature() != q["c"].program_signature()
    hash(q["a"].program_signature())
    q["c"].query_ast.selector.having = object()
    assert q["c"].program_signature() is None
    m.shutdown()
