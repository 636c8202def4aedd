"""The tumbling (batch) windows of ``ops/windows.py`` (lengthBatch,
timeBatch, batch, externalTimeBatch) and the selector's batch-mode
collapse (the last valid row per flush epoch and group), held against the
JAX package: whole apps under ``@app:playback`` on the same seeded feeds,
and each stage step by step on the same columns.

Tolerance (tests/torch_helpers.py): ints, strings, timestamps, types and
order exact; floats to rtol 1e-12."""

import numpy as np
import pytest
import torch
from torch_helpers import (PLAYBACK_STOCK, assert_arrays_match,
                           assert_both_match, mixed_feed, release_jax_programs)

from siddhi_tpu_torch.ops import windows as twin

APPS = {
    "length_batch_grouped": "from S#window.lengthBatch(4) select symbol, "
                            "sum(volume) as v group by symbol insert all events into O;",
    "length_batch_rows": "from S#window.lengthBatch(3) select symbol, price "
                         "insert all events into O;",
    "length_batch_stream_current": "from S#window.lengthBatch(3, true) "
                                   "select sum(volume) as v insert all events into O;",
    "length_batch_zero": "from S#window.lengthBatch(0) select symbol, "
                         "count() as n insert all events into O;",
    "time_batch": "from S#window.timeBatch(1 sec) select symbol, sum(volume) as v, "
                  "count() as n group by symbol insert into O;",
    "time_batch_start_time": "from S#window.timeBatch(1 sec, 300) "
                             "select sum(volume) as v insert all events into O;",
    "time_batch_stream_current": "from S#window.timeBatch(1 sec, true) "
                                 "select symbol, volume insert all events into O;",
    "batch": "from S#window.batch() select symbol, sum(volume) as v "
             "group by symbol insert all events into O;",
    "batch_chunk_length": "from S#window.batch(2) select count() as n "
                          "insert all events into O;",
    "external_time_batch": "from S#window.externalTimeBatch(ts, 1 sec) "
                           "select sum(volume) as v, count() as n "
                           "insert all events into O;",
    "external_time_batch_timeout": "from S#window.externalTimeBatch(ts, 1 sec, 200, "
                                   "500) select sum(volume) as v "
                                   "insert all events into O;",
    "expired_only": "from S#window.lengthBatch(5) select symbol, volume "
                    "insert expired events into O;",
}


@pytest.mark.parametrize("name", list(APPS))
def test_batch_window_apps_match_reference(name):
    n = assert_both_match(PLAYBACK_STOCK + "@info(name='q') " + APPS[name],
                          mixed_feed(13, n_events=16, n_batches=2),
                          config={"siddhi_tpu.window_capacity": "256"})
    assert n > 0


SPECS = {"v": np.float64, "v?": np.bool_, "n": np.int64, "n?": np.bool_,
         "ck": np.int64, "ck?": np.bool_, "__ts__": np.int64, "__gk__": np.int32}


def _ts_of(cols, ctx):
    return cols["ck"], None


@pytest.mark.parametrize("kind", ["length_batch", "length_batch_wide",
                                  "time_batch_stream_current", "batch_chunk",
                                  "external_time_batch_timeout"])
def test_batch_stage_matches_jax_step_by_step(kind):
    import jax
    import jax.numpy as jnp

    from siddhi_tpu.ops import windows as jwin

    make = {
        "length_batch": lambda m: m.LengthBatchWindowStage(5, SPECS),
        "length_batch_wide": lambda m: m.LengthBatchWindowStage(20, SPECS),
        "time_batch_stream_current": lambda m: m.TimeBatchWindowStage(
            60, SPECS, 64, stream_current=True),
        "batch_chunk": lambda m: m.BatchWindowStage(SPECS, 64, chunk_length=3),
        "external_time_batch_timeout": lambda m: m.ExternalTimeBatchWindowStage(
            _ts_of, 30, SPECS, 64, start_time=5, timeout=20),
    }[kind]
    jstage, tstage = make(jwin), make(twin)
    jstep = jax.jit(lambda st, c, now: jstage.apply(
        st, c, {"xp": jnp, "current_time": now}))
    jst, tst = jstage.init_state(1), tstage.init_state(1, "cpu")
    rng = np.random.default_rng(17)
    B, t = 16, 1000
    for i in range(8):
        ts = t + np.sort(rng.integers(0, 40, B)).astype(np.int64)
        cols = {"__type__": np.where(rng.random(B) < 0.15, 2, 0).astype(np.int8),
                "__valid__": rng.random(B) < 0.85, "__ts__": ts,
                "__gk__": rng.integers(0, 3, B).astype(np.int32),
                "v": rng.standard_normal(B), "v?": rng.random(B) < 0.1,
                "n": rng.integers(-9, 9, B), "n?": np.zeros(B, bool),
                "ck": ts + rng.integers(-30, 31, B), "ck?": np.zeros(B, bool)}
        now = int(ts.max()) + int(rng.integers(0, 30))
        t = int(ts.max()) + int(rng.integers(0, 60))
        jst, jout = jstep(jst, {k: jnp.asarray(v) for k, v in cols.items()},
                          np.int64(now))
        tst, tout = tstage.apply(tst, tstage.conform(
            {k: torch.from_numpy(v.copy()) for k, v in cols.items()}),
            {"current_time": now})
        assert set(tout) == set(jout)
        for k in jout:
            assert_arrays_match(tout[k].numpy().reshape(np.shape(jout[k])),
                                np.asarray(jout[k]), f"step {i} {k}")
        for path, leaf in jax.tree_util.tree_leaves_with_path(jst):
            node = tst
            for p in path:
                node = node[p.key]
            assert_arrays_match(node.numpy(), np.asarray(leaf), f"state {i} {path}")


ETB_TIMEOUT = """@app:playback define stream S (ets long, v int);
@info(name = 'q') from S#window.externalTimeBatch(ets, 10 sec, 0, 1 sec)
select sum(v) as total insert into O;"""

# tests/test_window_params.py's externalTimeBatch scenarios: (time, [ets, v])
ETB_SENDS = {
    "timeout_flushes_idle_batch": [(1000, [1000, 5]), (1200, [1200, 7]),
                                   (2500, [1300, 0])],
    "crossing_appends_after_timeout_flush": [(1000, [1000, 5]), (2500, [1200, 7]),
                                             (2600, [11000, 1])],
    "timeout_flush_then_double_crossing": [(1000, [1000, 5]), (2500, [1200, 7]),
                                           (2600, [11000, 1]), (2700, [25000, 2])],
}


@pytest.mark.parametrize("name", list(ETB_SENDS))
def test_external_time_batch_timeout_corpus_matches_reference(name):
    feed = [("event", t, row) for t, row in ETB_SENDS[name]]
    assert assert_both_match(ETB_TIMEOUT, feed, query_callback=True) > 0
