"""Sequences on the port against the reference, on the CPU.

- Every scenario of ``test_sequence_corpus.py`` drives the port through
  the module's own feed and checks the module's own expected rows (the
  reference's outputs: the same module asserts them of the JAX package).
- Seeded random feeds on two streams go through both packages for the
  sequence shapes the corpus pins: strict continuity, trailing and
  leading ``*``, ``?``, ``+``, an ``or`` step, mid-chain counts, with and
  without ``every`` and ``within``. Ints, strings, timestamps and row
  order must match exactly, floats to rtol 1e-12.
"""

import pytest

from torch_helpers import (  # release_jax_programs: an autouse fixture
    assert_multi_match, port_corpus, release_jax_programs, two_stream_feed)

SEQUENCE_CORPUS, SEQUENCE_TESTS = port_corpus("test_sequence_corpus")


@pytest.mark.parametrize("name", SEQUENCE_TESTS)
def test_sequence_corpus_on_port(name):
    getattr(SEQUENCE_CORPUS, name)()


_HEAD = """@app:playback
define stream A (k string, v double);
define stream B (k string, v double);
"""

SHAPES = {
    "two_step": "from every e1=A, e2=B select e1.v as a, e2.v as b",
    "every_two_step_within": (
        "from every e1=A, e2=B[v > e1.v] within 1 sec "
        "select e1.k as k, e1.v as a, e2.v as b"),
    "trailing_star": (
        "from every e1=A[v > 3.0], e2=B[v > e1.v]* "
        "select e1.v as a, e2[0].v as b0, e2[1].v as b1"),
    "leading_star": (
        "from every e1=B[v > 2.0]*, e2=A[v > e1[0].v] "
        "select e1[0].v as b0, e1[1].v as b1, e2.v as a"),
    "optional": (
        "from every e1=B[v > 5.0]?, e2=A[v > 1.0] "
        "select e1[0].v as b, e2.v as a"),
    "plus_last": (
        "from every e1=A+, e2=B[v > e1[last].v] "
        "select e1[0].v as f, e1[last].v as l, e2.v as b"),
    "or_step": (
        "from every e1=A, e2=B[v > e1.v] or e3=A[v < e1.v] "
        "select e1.v as a, e2.v as b, e3.v as c"),
    "mid_star": (
        "from every e1=A[v > 6.0], e2=B[v > 2.0]*, e3=A[v < 3.0] "
        "select e1.v as a, e2[0].v as b, e3.v as c"),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_sequence_shapes_match_reference(shape):
    feed = two_stream_feed(sum(map(ord, shape)) + 7, n_items=36)
    assert assert_multi_match(
        _HEAD + "@info(name='q') " + SHAPES[shape] + " insert into O;", feed) > 0
