"""Patterns on the port (``ops/nfa.py``, ``core/query/nfa_runtime.py``)
against the reference, on the CPU.

- Every scenario of ``test_pattern_corpus.py``, ``test_every_count.py``,
  ``test_patterns.py``, ``test_logical_within_corpus.py`` and
  ``test_complex_corpus.py`` drives the port through the module's own
  feed and checks the module's own expected rows (ported from the
  reference's Java test cases; the same module asserts them of the JAX
  package).
- Seeded random feeds on two streams go through both packages for the
  pattern shapes the corpus pins: counts with indexed captures
  (``e1[0]``, ``e1[last]``), logical and/or steps, ``every`` groups,
  whole-pattern and scoped ``within``, a group by over captures. Ints,
  strings, timestamps and row order must match exactly, floats to rtol
  1e-12 (``torch_helpers``).
"""

import pytest

from torch_helpers import (  # release_jax_programs: an autouse fixture
    assert_multi_match, port_corpus, release_jax_programs, two_stream_feed)

PATTERN_CORPUS, PATTERN_TESTS = port_corpus("test_pattern_corpus")
EVERY_COUNT, EVERY_COUNT_TESTS = port_corpus("test_every_count")
MORE = {n: port_corpus(n) for n in (
    "test_patterns", "test_logical_within_corpus", "test_complex_corpus")}
MORE_CASES = [(n, t) for n, (_m, tests) in MORE.items() for t in tests]


@pytest.mark.parametrize("name", PATTERN_TESTS)
def test_pattern_corpus_on_port(name):
    getattr(PATTERN_CORPUS, name)()


@pytest.mark.parametrize("name", EVERY_COUNT_TESTS)
def test_every_count_corpus_on_port(name):
    getattr(EVERY_COUNT, name)()


@pytest.mark.parametrize("module,name", MORE_CASES)
def test_pattern_modules_on_port(module, name):
    getattr(MORE[module][0], name)()


_HEAD = """@app:playback
define stream A (k string, v double);
define stream B (k string, v double);
"""

SHAPES = {
    # a count with indexed captures and e[last]
    "count_indexed": """
        @info(name='q') from e1=A[v > 2.0] <2:5> -> e2=B[v > e1[last].v]
        select e1[0].v as f, e1[1].v as s, e1[last].v as l, e2.v as t, e2.k as k
        insert into O;""",
    "every_count_within": """
        @info(name='q') from every e1=A <2> -> e2=B within 1 sec
        select e1[0].v as a0, e1[1].v as a1, e2.v as b insert into O;""",
    "logical_and_then": """
        @info(name='q') from every e1=A and e2=B -> e3=A[v > e1.v]
        select e1.v as a, e2.v as b, e3.v as c insert into O;""",
    "logical_or": """
        @info(name='q') from every e1=A[v > 5.0] or e2=B[v < 2.0] -> e3=B
        select e1.v as a, e2.v as b, e3.v as c insert into O;""",
    "every_group_within": """
        @info(name='q') from every (e1=A -> e2=B[v > e1.v]) within 1 sec
        select e1.k as k, e1.v as a, e2.v as b insert into O;""",
    "mid_chain_every": """
        @info(name='q') from e1=A -> every e2=B[v > e1.v] -> e3=A[v < e2.v]
        select e1.v as a, e2.v as b, e3.v as c insert into O;""",
    "scoped_within": """
        @info(name='q') from every e1=A[v > 6.0] -> (e2=B -> e3=A) within 2 sec
        select e1.v as a, e2.v as b, e3.v as c insert into O;""",
    "group_by_sum": """
        @info(name='q') from every e1=A -> e2=B[v > e1.v] within 1 sec
        select e1.k as k, sum(e2.v) as total, count() as n group by e1.k
        insert into O;""",
    "non_every_count_head": """
        @info(name='q') from e1=A <1:3> -> e2=B within 2 sec
        select e1[0].v as a, e1[last].v as l, e2.v as b insert into O;""",
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_pattern_shapes_match_reference(shape):
    feed = two_stream_feed(sum(map(ord, shape)), n_items=36)
    assert assert_multi_match(_HEAD + SHAPES[shape], feed) > 0


def test_pattern_compiles_and_join_still_refused():
    import siddhi_tpu_torch
    from siddhi_tpu_torch.ops.expressions import CompileError

    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(
        _HEAD + "@info(name='q') from e1=A -> e2=B select e1.v as a insert into O;")
    assert type(rt.query_runtimes["q"]).__name__ == "NFAQueryRuntime"
    # a join plans into its own runtime now; routing this unpartitioned one
    # over a mesh is refused for the reference's reason (JOIN_UNPARTITIONED);
    # a partitioned keyed-length one routes (test_torch_isolation.py)
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    rt = m.create_siddhi_app_runtime(
        _HEAD + "@info(name='j') from A#window.length(2) join B#window.length(2) "
                "on A.k == B.k select A.v as a insert into O;")
    assert type(rt.query_runtimes["j"]).__name__ == "JoinQueryRuntime"
    with pytest.raises(CompileError, match="non-partitioned joins"):
        device_route_query_step(rt.query_runtimes["j"], make_mesh(2))
    m.shutdown()
