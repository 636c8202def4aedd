"""Absent patterns and sequences on the port against the reference, on the
CPU: `not X for t` waits whose deadlines fire lazily on same-key events
and as TIMER steps (``NFAStage.apply_timer``) when the playback clock
passes them, the head wait armed at the app clock's first value, logical
steps with absent sides and ``every`` re-arming.

- Every scenario of ``test_absent_corpus.py``, ``test_absent_patterns.py``
  and ``test_absent_sequences.py`` drives the port through the module's
  own feed and checks the module's own expected rows (the reference's
  outputs: the same modules assert them of the JAX package).
- Seeded random feeds go through both packages for the absent shapes.
  Ints, strings, timestamps and row order must match exactly, floats to
  rtol 1e-12.
"""

import pytest

from torch_helpers import (  # release_jax_programs: an autouse fixture
    assert_multi_match, port_corpus, release_jax_programs, two_stream_feed)

CORPORA = {n: port_corpus(n) for n in (
    "test_absent_corpus", "test_absent_patterns", "test_absent_sequences")}
CASES = [(n, t) for n, (_m, tests) in CORPORA.items() for t in tests]


@pytest.mark.parametrize("module,name", CASES)
def test_absent_corpus_on_port(module, name):
    getattr(CORPORA[module][0], name)()


_HEAD = """@app:playback
define stream A (k string, v double);
define stream B (k string, v double);
"""

SHAPES = {
    "tail_not": (
        "from every e1=A[v > 5.0] -> not B[v > e1.v] for 1 sec "
        "select e1.k as k, e1.v as a"),
    "head_not": (
        "from not A[v > 8.0] for 1 sec -> e2=B[v > 2.0] select e2.v as b"),
    "every_head_not_seq": (
        "from every not A[v > 8.0] for 1 sec, e2=B[v > 3.0] select e2.v as b"),
    "mid_not": (
        "from every e1=A[v > 7.0] -> not B[v > e1.v] for 500 milliseconds "
        "-> e3=A[v < 2.0] select e1.v as a, e3.v as c"),
    "and_not_for": (
        "from every e1=A[v > 6.0] -> not B[v > 8.0] for 1 sec and e3=A[v < 3.0] "
        "select e1.v as a, e3.v as c"),
    "or_not_for": (
        "from every e1=A[v > 6.0] -> not B[v > 8.0] for 1 sec or e3=B[v < 1.0] "
        "select e1.v as a, e3.v as c"),
    "every_tail_not": (
        "from e1=A[v > 9.0] -> every not B[v > e1.v] for 1 sec "
        "select e1.v as a"),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_absent_shapes_match_reference(shape):
    feed = two_stream_feed(sum(map(ord, shape)) + 11, n_items=30)
    assert assert_multi_match(
        _HEAD + "@info(name='q') " + SHAPES[shape] + " insert into O;", feed) > 0
