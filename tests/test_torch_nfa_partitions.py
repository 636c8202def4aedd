"""Patterns and sequences inside partitions on the port, on the CPU.

- Every scenario of ``test_sequence_partition_corpus.py`` drives the port
  through the module's own feed and checks the module's own expected rows
  (the reference's outputs: the same module asserts them of the JAX
  package).
- Config #4 (``BASELINE.json``, ``bench.py`` ``bench_nfa_p99``) cut to 64
  keys, and a partitioned absent pattern, go through both packages on a
  seeded feed. On the port, config #4 at pipeline depth 4 and a pattern
  behind ``@Async`` at depth 4 equal their synchronous runs.
- ``@purge`` under a pattern: retired keys' ids are reused by new keys
  that start with no pending match, in both packages alike.
- ``load_reference_state``: the JAX package's NFA state, string
  dictionary, key space and high-water marks carried into the port
  mid-feed; the rest of the feed gives the same rows in both.
Ints, strings, timestamps and row order match exactly, floats to rtol
1e-12.
"""

import time

import jax
import numpy as np
import pytest

from torch_helpers import (  # release_jax_programs: an autouse fixture
    Run, assert_multi_match, assert_rows_match, port_corpus,
    release_jax_programs, send_multi, two_stream_feed)

from siddhi_tpu_torch.interop import load_reference_state

SEQ_PART, SEQ_PART_TESTS = port_corpus("test_sequence_partition_corpus")

CONFIG4 = """@app:playback
define stream AStream (k string, v double);
define stream BStream (k string, v double);
partition with (k of AStream, k of BStream)
begin
  @info(name='q')
  from every e1=AStream -> e2=BStream[e2.v > e1.v] within 5 sec
  select e1.k as k, e1.v as v1, e2.v as v2
  insert into O;
end;
"""

ABSENT_PART = """@app:playback
define stream AStream (k string, v double);
define stream BStream (k string, v double);
partition with (k of AStream, k of BStream)
begin
  @info(name='q')
  from every e1=AStream -> not BStream[v > e1.v] for 1 sec
  select e1.k as k, e1.v as v1
  insert into O;
end;
"""


@pytest.mark.parametrize("name", SEQ_PART_TESTS)
def test_sequence_partition_corpus_on_port(name):
    getattr(SEQ_PART, name)()


def config4_feed(seed, pairs, B, n_keys, step_ms, independent):
    """``bench_nfa_p99``'s feed: each A batch is followed by a B batch
    (the same keys and ``v + 1``, or keys and values drawn anew)."""
    rng = np.random.default_rng(seed)
    keys = np.array([f"key{i}" for i in range(n_keys)], dtype=object)
    feed, t = [], 1000
    for _ in range(pairs):
        ids = rng.integers(0, n_keys, B)
        v = np.round(rng.random(B) * 100, 2)
        ts = np.full(B, t, np.int64)
        feed.append(("AStream", {"k": keys[ids], "v": v}, ts))
        if independent:
            feed.append(("BStream", {"k": keys[rng.integers(0, n_keys, B)],
                                     "v": np.round(rng.random(B) * 100, 2)}, ts + 1))
        else:
            feed.append(("BStream", {"k": keys[ids], "v": v + 1}, ts + 1))
        t += step_ms
    return feed


@pytest.mark.parametrize("independent,step_ms", [(False, 10), (True, 1000)],
                         ids=["bench_feed", "expiring"])
def test_config4_matches_reference(independent, step_ms):
    feed = config4_feed(3, 8, 64, 64, step_ms, independent)
    assert assert_multi_match(CONFIG4, feed,
                              config={"siddhi_tpu.nfa_slots": "16"}) > 0


def test_partitioned_absent_matches_reference():
    feed = two_stream_feed(17, streams=("AStream", "BStream"), n_items=30,
                           n_keys=6)
    assert assert_multi_match(ABSENT_PART, feed) > 0


ASYNC_ONE_STREAM = """@app:playback
{ann}define stream S (src string, k string, v double);
partition with (k of S)
begin
  @info(name='q')
  from every e1=S[src == 'A'] -> e2=S[src == 'B' and v > e1.v] within 2 sec
  select e1.k as k, e1.v as v1, e2.v as v2
  insert into O;
end;
"""


def test_pattern_pipelined_at_depth_4_equals_sync():
    """Config #4 with its steps riding the dispatch pipeline (depth 4):
    the same rows in the same order as depth 1."""
    feed = config4_feed(9, 6, 64, 16, 700, True)
    rows = {}
    for depth in (1, 4):
        r = Run("torch", CONFIG4, "O", "q",
                config={"siddhi_tpu.pipeline_depth": str(depth)})
        send_multi(r.rt, feed)
        rows[depth] = r.close()
    assert len(rows[1]) > 0
    assert rows[4] == rows[1]


def test_pattern_behind_async_at_depth_4_equals_sync():
    """A one-stream pattern behind an @Async junction (one worker keeps
    the stream's order) at depth 4 equals the synchronous run at depth 1."""
    rng = np.random.default_rng(12)
    feed = []
    for i in range(12):
        n = 16
        feed.append(("S", {"src": np.array(["A", "B"], object)[rng.integers(0, 2, n)],
                           "k": np.array([f"k{j}" for j in range(5)], object)[
                               rng.integers(0, 5, n)],
                           "v": np.round(rng.random(n) * 10, 1)},
                     np.full(n, 1000 + 400 * i, np.int64)))
    rows = {}
    for depth, ann in ((1, ""), (4, "@Async(buffer.size='64', batch.size='16')\n")):
        r = Run("torch", ASYNC_ONE_STREAM.format(ann=ann), "O", "q",
                config={"siddhi_tpu.pipeline_depth": str(depth)})
        send_multi(r.rt, feed)
        rows[depth] = r.close()
    assert len(rows[1]) > 0
    assert rows[4] == rows[1]


def _purge_run(pkg):
    """Keys key0..key7 arm pendings; key0..key3 retire by @purge; new keys
    take their ids and must find no pending match."""
    app = CONFIG4.replace(
        "partition with", "@purge(enable='true', interval='1 hour', "
                          "idle.period='1 hour')\npartition with")
    r = Run(pkg, app, "O", "q")
    h = {s: r.rt.get_input_handler(s) for s in ("AStream", "BStream")}
    old = np.array([f"key{i}" for i in range(8)], object)
    h["AStream"].send_columns({"k": old, "v": np.arange(8.0)},
                              timestamps=np.full(8, 1000, np.int64))
    pctx = r.rt.partition_contexts[0]
    ks = pctx.keyspace
    enc = r.rt.app_context.string_dictionary.encode
    retired = sorted(ks._map[(enc(f"key{i}"),)] for i in range(4))
    for i in retired:
        ks.last_seen[i] = int(time.time() * 1000) - 2 * 3600_000
    assert sorted(pctx.purge()) == retired
    new = np.array([f"new{i}" for i in range(4)], object)
    h["BStream"].send_columns(
        {"k": np.concatenate([new, old[4:]]), "v": np.full(8, 50.0)},
        timestamps=np.full(8, 1500, np.int64))
    ids = sorted(ks._map[(enc(f"new{i}"),)] for i in range(4))
    return r.close(), ids, retired


def test_purge_under_a_pattern_recycles_clean_ids():
    want, _, _ = _purge_run("jax")
    got, ids, retired = _purge_run("torch")
    assert ids == retired
    assert_rows_match(got, want)
    # only the surviving keys matched; the new keys had no pending A
    assert sorted(row[1][0] for row in got) == [f"key{i}" for i in range(4, 8)]


@pytest.mark.parametrize("fast", [True, False], ids=["k4", "k5"])
def test_reference_state_carried_mid_feed(fast):
    feed = config4_feed(21, 8, 32, 48, 1500, True)
    first, second = feed[:7], feed[7:]      # stop between an A and its B
    jax_run = Run("jax", CONFIG4, "O", "q", config={"siddhi_tpu.nfa_slots": "16"})
    send_multi(jax_run.rt, first)
    q = jax_run.query
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(q._state))
    port = Run("torch", CONFIG4, "O", "q", config={"siddhi_tpu.nfa_slots": "16"})
    port.query.stage.fast_enabled = fast
    load_reference_state(
        port.query, tree,
        dictionary_ids=list(jax_run.rt.app_context.string_dictionary._to_str),
        partition_keys=jax_run.rt.partition_contexts[0].keyspace.snapshot(),
        nfa_hwm=q._nfa_hwm_arr)
    n_first = len(jax_run.collector.rows)
    send_multi(jax_run.rt, second)
    want = jax_run.close()[n_first:]
    send_multi(port.rt, second)
    got = port.close()
    assert len(want) > 0
    assert_rows_match(got, want)


def test_pattern_on_a_mesh_is_refused_naming_itself():
    from siddhi_tpu_torch.ops.expressions import CompileError
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    r = Run("torch", CONFIG4, "O", "q")
    # the reference's reason and code (NFA_QUERY): neither package routes
    # an NFA step
    with pytest.raises(CompileError, match=r"pattern/sequence \(NFA\) queries"):
        device_route_query_step(r.query, make_mesh(2))
    r.close()
