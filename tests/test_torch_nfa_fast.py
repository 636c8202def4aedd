"""The port's fast two-step kernel (K4, ``NFAStage._apply_stream_fast``)
against its generic engine (K5, ``_apply_stream_generic``) and against
the reference, on the CPU.

- ``test_nfa_fast_differential.py``'s shapes and seeded feeds: the port's
  K4 run equals its K5 run (``stage.fast_enabled = False``) row for row,
  unpartitioned and partitioned, and the partitioned runs equal the JAX
  package's (ints, strings, timestamps and order exactly, floats to rtol
  1e-12).
- The module's own minimized cases (an in-batch expiry straddle, slot
  overflow parity, an out-of-order timestamp that must not resurrect an
  expired pending) drive the port.
- An out-of-order batch takes the host's hard-batch path
  (``NFAQueryRuntime._host_hard_batch`` -> ``expire_to`` -> K5) and
  still equals the reference.
"""

import zlib

import numpy as np
import pytest

from torch_helpers import (  # release_jax_programs: an autouse fixture
    Run, assert_rows_match, port_corpus, release_jax_programs, send_multi)

FAST, FAST_TESTS = port_corpus("test_nfa_fast_differential")
PATTERNS = FAST.PATTERNS


def _partitioned(name):
    return PATTERNS[name].replace(
        "from ", "partition with (k of A, k of B) begin @info(name='q') from ", 1
    ).replace("insert into M;", "insert into M; end;")


@pytest.mark.parametrize("name", FAST_TESTS)
def test_fast_differential_corpus_on_port(name):
    getattr(FAST, name)()


@pytest.mark.parametrize("partitioned", [False, True])
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_port_fast_equals_generic(name, partitioned):
    if partitioned:
        app, n_keys, seed = _partitioned(name), 5, zlib.crc32(name.encode()) // 2
    else:
        app, n_keys, seed = PATTERNS[name], 1, zlib.crc32(name.encode())
    feeds = FAST._random_feeds(np.random.default_rng(seed), n_batches=40,
                               max_rows=8, n_keys=n_keys, ts_jump_ms=700)
    fast, ef = FAST._drive(app, feeds, fast=True, slots=16)
    slow, es = FAST._drive(app, feeds, fast=False, slots=16)
    assert ef == es
    assert fast == slow


def _run(pkg, app, feeds, fast=True):
    r = Run(pkg, app, "M", "q", config={"siddhi_tpu.nfa_slots": "16"})
    stage = r.query.stage
    stage.fast_enabled = fast
    send_multi(r.rt, feeds)
    return r.close(), stage


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_port_fast_matches_reference(name):
    feeds = FAST._random_feeds(
        np.random.default_rng(zlib.crc32(name.encode()) // 3), n_batches=30,
        max_rows=8, n_keys=5, ts_jump_ms=700)
    want, _ = _run("jax", _partitioned(name), feeds)
    got, stage = _run("torch", _partitioned(name), feeds)
    assert_rows_match(got, want)
    assert stage.fast_steps > 0


def test_out_of_order_batch_takes_the_host_fallback():
    """A batch below its keys' high-water marks is hard for K4: the host
    applies the per-key expiry clears, then runs K5 on it."""
    rng = np.random.default_rng(5)
    keys = np.array(["K0", "K1", "K2"], object)
    feeds = []
    for t in (1_000, 2_500, 4_000, 3_000, 5_500):     # 3_000 is late
        for s in ("A", "B"):
            feeds.append((s, {"k": keys[rng.integers(0, 3, 6)],
                              "v": np.round(rng.random(6) * 10, 1)},
                          np.full(6, t + (5 if s == "B" else 0), np.int64)))
    app = _partitioned("every-pattern-within")
    want, _ = _run("jax", app, feeds)
    got, stage = _run("torch", app, feeds)
    assert_rows_match(got, want)
    assert len(want) > 0
    assert stage.generic_steps >= 1 and stage.fast_steps >= 1


def test_ineligible_plans_take_generic_path():
    """3-step, absent, count and same-stream chains never take K4."""
    import siddhi_tpu_torch

    cases = [
        "from every e1=A -> e2=B -> e3=A select e1.v as v1 insert into M;",
        "from every e1=A -> not B for 1 sec select e1.v as v1 insert into M;",
        "from every e1=A<1:3> -> e2=B select e2.v as v2 insert into M;",
        "from every e1=A -> e2=A[e2.v > e1.v] select e1.v as v1 insert into M;",
    ]
    for q in cases:
        m = siddhi_tpu_torch.SiddhiManager(device="cpu")
        rt = m.create_siddhi_app_runtime(
            "@app:playback define stream A (k string, v double); "
            "define stream B (k string, v double); " + q)
        stage = rt.query_runtimes[list(rt.query_runtimes)[0]].stage
        assert stage._fast_side("A") is None, q
        assert stage._fast_side("B") is None, q
        m.shutdown()


def _spread_feed(seed, n_pairs=12, a_rows=24, b_rows=3, span=1800, gap=666):
    """One key: A batches whose rows spread over most of `within` (2 s),
    each followed by a short B batch, so live matches' deadlines fall
    between a head batch's rows."""
    rng = np.random.default_rng(seed)
    feeds, t = [], 1_000
    for _ in range(n_pairs):
        ts = t + np.sort(rng.integers(0, span, a_rows)).astype(np.int64)
        feeds.append(("A", {"k": np.array(["K0"] * a_rows, object),
                            "v": np.round(rng.random(a_rows) * 10, 1)}, ts))
        tb = int(ts.max()) + int(rng.integers(0, 3))
        tsb = tb + np.sort(rng.integers(0, 40, b_rows)).astype(np.int64)
        feeds.append(("B", {"k": np.array(["K0"] * b_rows, object),
                            "v": np.round(rng.random(b_rows) * 10, 1)}, tsb))
        t = int(tsb.max()) + int(rng.integers(1, gap))
    return feeds


@pytest.mark.parametrize("seed", [0, 1])
def test_spread_head_batches_run_as_k4_steps(seed):
    """An unpartitioned pattern's head batches spread over several
    instants run as K4 steps over runs of rows, cut where a live match's
    deadline falls (``NFAQueryRuntime._head_runs``), not as K5's one round
    a row: no K5 step, more K4 steps than batches, and the rows equal the
    reference's."""
    feeds = _spread_feed(seed)
    app = PATTERNS["every-pattern-within"].replace("from ", "@info(name='q') from ", 1)
    r = Run("jax", app, "M", "q", config={"siddhi_tpu.nfa_slots": "64"})
    send_multi(r.rt, feeds)
    want = r.close()
    r = Run("torch", app, "M", "q", config={"siddhi_tpu.nfa_slots": "64"})
    stage = r.query.stage
    send_multi(r.rt, feeds)
    got = r.close()
    assert len(want) > 100
    assert_rows_match(got, want)
    assert stage.generic_steps == 0
    assert stage.fast_steps > len(feeds) + 12
