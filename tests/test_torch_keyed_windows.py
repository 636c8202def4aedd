"""The keyed (inside-partition) window stages of ``ops/keyed_windows.py``
held against the JAX package step by step on the same state and columns
(numpy inputs from fixed seeds): time, timeLength, externalTime,
lengthBatch, timeBatch, session, hopping and batch. Covers the ring and
in-batch expiry, invalid and TIMER rows, partition ids at and past key
capacity, a non-monotone externalTime clock, timeLength evictions, session
breaks inside one batch, more than 128 idle session keys, overflow, and
each stage's ``reset_keys`` and ``contents``.

The time and session stages emit only the rows that expire (the
reference emits every ring slot, most of them invalid): their valid rows,
sorted first, are compared; the other stages' whole emission is.
Tolerance (tests/torch_helpers.py): ints exact, floats to rtol 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import assert_arrays_match, release_jax_programs

from siddhi_tpu.ops import keyed_windows as jkw
from siddhi_tpu_torch.ops import keyed_windows as tkw

SPECS = {"v": np.float64, "v?": np.bool_, "n": np.int64, "n?": np.bool_,
         "ck": np.int64, "ck?": np.bool_, "__ts__": np.int64,
         "__gk__": np.int32, "__pk__": np.int32}

COMPACTED = ("time", "time_length", "external", "session")


def _batches(seed, steps, B, K, kind, timers=0.1, invalid=0.15, pk_hi=None,
             gap=(0, 40), shuffle_ck=False, first_t=1000):
    """(cols, now) per step: keys in [0, pk_hi) (past capacity K is
    clipped by the stage), timestamps that creep, jump and stand still,
    some TIMER and invalid rows."""
    rng = np.random.default_rng(seed)
    pk_hi = pk_hi or K
    out, t = [], first_t
    for s in range(steps):
        ts = np.sort(t + rng.integers(gap[0], gap[1], B)).astype(np.int64)
        ck = ts + (rng.integers(-60, 61, B) if shuffle_ck else 0)
        types = np.where(rng.random(B) < timers, 2, 0).astype(np.int8)
        pk = rng.integers(0, pk_hi, B).astype(np.int32)
        out.append(({"__type__": types, "__valid__": rng.random(B) >= invalid,
                     "__ts__": ts, "__gk__": pk, "__pk__": pk,
                     "v": np.round(rng.standard_normal(B) * 10, 3),
                     "v?": rng.random(B) < 0.1,
                     "n": rng.integers(0, 1000, B), "n?": np.zeros(B, bool),
                     "ck": ck.astype(np.int64), "ck?": np.zeros(B, bool)},
                    int(ts.max()) + int(rng.integers(0, 30))))
        t = int(ts.max()) + int(rng.choice([0, 5, 50, 400]))
    return out


def _timer_batch(B, now):
    """A one-row TIMER chunk padded to B (the scheduler's chunk)."""
    z = np.zeros(B, np.int64)
    cols = {"__type__": np.full(B, 2, np.int8), "__valid__": np.arange(B) < 1,
            "__ts__": np.full(B, now, np.int64), "__gk__": z.astype(np.int32),
            "__pk__": z.astype(np.int32), "v": np.zeros(B), "v?": np.zeros(B, bool),
            "n": z, "n?": np.zeros(B, bool), "ck": z, "ck?": np.zeros(B, bool)}
    return cols, now


STAGES = {
    # name: (factory(module), K, batches)
    "time": (lambda m: m.KeyedTimeWindowStage(120, SPECS, 32), 16,
             lambda: _batches(1, 10, 32, 16, "time")),
    "time_past_capacity": (lambda m: m.KeyedTimeWindowStage(80, SPECS, 32), 16,
                           lambda: _batches(2, 8, 32, 16, "time", pk_hi=20)),
    "time_length": (lambda m: m.KeyedTimeWindowStage(300, SPECS, 16, max_len=3), 16,
                    lambda: _batches(3, 10, 32, 16, "tl")),
    "external": (lambda m: m.KeyedTimeWindowStage(100, SPECS, 32, external=True,
                                                  ts_key="ck"), 16,
                 lambda: _batches(4, 10, 32, 16, "ext", shuffle_ck=True)),
    "external_monotone": (lambda m: m.KeyedTimeWindowStage(
        100, SPECS, 32, external=True, ts_key="ck"), 16,
        lambda: _batches(5, 10, 32, 16, "ext")),
    "length_batch": (lambda m: m.KeyedLengthBatchWindowStage(3, SPECS), 16,
                     lambda: _batches(6, 8, 32, 16, "lb", pk_hi=6)),
    "time_batch": (lambda m: m.KeyedTimeBatchWindowStage(100, SPECS, 32), 16,
                   lambda: _batches(7, 10, 24, 16, "tb")),
    "session": (lambda m: m.KeyedSessionWindowStage(30, SPECS, 16), 16,
                lambda: _batches(8, 10, 32, 16, "s", gap=(0, 120), pk_hi=5)),
    "session_past_capacity": (lambda m: m.KeyedSessionWindowStage(50, SPECS, 16), 16,
                              lambda: _batches(9, 8, 32, 16, "s", gap=(0, 200),
                                               pk_hi=19)),
    "hopping": (lambda m: m.KeyedHoppingWindowStage(200, 70, SPECS, 32), 16,
                lambda: _batches(10, 10, 24, 16, "h")),
    "batch": (lambda m: m.KeyedBatchWindowStage(SPECS, 16), 16,
              lambda: _batches(11, 8, 24, 16, "b", pk_hi=8)),
}


def _to_jax(cols):
    return {k: jnp.asarray(v) for k, v in cols.items()}


def _to_torch(cols):
    return {k: torch.from_numpy(np.array(v)) for k, v in cols.items()}


def _compare_step(name, i, jout, tout, compacted):
    assert set(tout) == set(jout), (set(tout) ^ set(jout))
    n = int(np.asarray(jout["__valid__"]).sum())
    assert int(tout["__valid__"].sum()) == n, (i, int(tout["__valid__"].sum()), n)
    for k in jout:
        want = np.asarray(jout[k])
        got = tout[k].numpy()
        if want.ndim == 0:
            got = got.reshape(())
        elif compacted:
            got, want = got[:n], want[:n]
        assert_arrays_match(got, want, f"{name} step {i} {k}")


def _compare_state(name, i, jst, tst):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jst):
        node = tst
        for p in path:
            node = node[p.key]
        assert_arrays_match(node.numpy(), np.asarray(leaf), f"{name} state {i} {path}")


def _run(name, jstage, tstage, K, batches, compare_state=True):
    jst, tst = jstage.init_state(K), tstage.init_state(K, "cpu")
    jstep = jax.jit(lambda st, c, now: jstage.apply(st, c, {"xp": jnp,
                                                            "current_time": now}))
    compacted = name.split("_past")[0] in COMPACTED or name.startswith("external")
    emitted = 0
    for i, (cols, now) in enumerate(batches):
        jst, jout = jstep(jst, _to_jax(cols), np.int64(now))
        tst, tout = tstage.apply(tst, tstage.conform(_to_torch(cols)),
                                 {"current_time": now})
        _compare_step(name, i, jout, tout, compacted)
        if compare_state:
            _compare_state(name, i, jst, tst)
        emitted += int(np.asarray(jout["__valid__"]).sum())
    return jst, tst, emitted


@pytest.mark.parametrize("name", list(STAGES))
def test_keyed_stage_matches_jax_step_by_step(name):
    make, K, batches = STAGES[name]
    jstage, tstage = make(jkw), make(tkw)
    feed = batches()
    # the chunks end with a clock jump and a TIMER step that drains
    last = feed[-1][1]
    feed.append(_timer_batch(32 if name != "time_batch" else 24, last + 500))
    jst, tst, emitted = _run(name, jstage, tstage, K, feed)
    assert emitted > 0
    # contents (the join/find probe surface) agree
    jc, jv = jstage.contents(jst)
    tc, tv = tstage.contents(tst)
    assert_arrays_match(tv.numpy(), np.asarray(jv), f"{name} contents valid")
    for k in jc:
        live = np.asarray(jv)
        assert_arrays_match(tc[k].numpy()[live], np.asarray(jc[k])[live],
                            f"{name} contents {k}")
    # reset_keys (@purge) restarts the keys in place, as the reference
    ids = np.array([0, 3, 5], np.int32)
    jst2 = jstage.reset_keys(jst, jnp.asarray(ids))
    tst2 = tstage.reset_keys(tst, torch.from_numpy(ids.astype(np.int64)))
    _compare_state(name, "reset", jst2, tst2)
    # and the stages go on equal after it
    more = STAGES[name][2]()[:3]
    jstep = jax.jit(lambda st, c, now: jstage.apply(st, c, {"xp": jnp,
                                                            "current_time": now}))
    compacted = name.split("_past")[0] in COMPACTED or name.startswith("external")
    shift = last + 1000
    for i, (cols, now) in enumerate(more):
        cols = dict(cols, __ts__=cols["__ts__"] + shift, ck=cols["ck"] + shift)
        jst2, jout = jstep(jst2, _to_jax(cols), np.int64(now + shift))
        tst2, tout = tstage.apply(tst2, tstage.conform(_to_torch(cols)),
                                  {"current_time": now + shift})
        _compare_step(name, f"after reset {i}", jout, tout, compacted)
        _compare_state(name, f"after reset {i}", jst2, tst2)


def test_keyed_time_in_batch_expiry_and_ring():
    """Rows expire both from the ring and inside the batch (a key's row
    older than the cutoff before its next row), and the timeLength cap
    evicts from the ring and from the batch."""
    for factory in (lambda m: m.KeyedTimeWindowStage(50, SPECS, 16),
                    lambda m: m.KeyedTimeWindowStage(500, SPECS, 16, max_len=2)):
        jstage, tstage = factory(jkw), factory(tkw)
        feed = _batches(21, 6, 32, 16, "t", gap=(0, 200), pk_hi=3, timers=0.0)
        _j, _t, emitted = _run("time", jstage, tstage, 16, feed)
        assert emitted > 0


def test_keyed_session_many_idle_keys_and_breaks():
    """More than 128 keys go idle at once: the sweep drains 128 a step in
    key order and re-arms at once; breaks inside one batch emit each
    broken session in its row's lane."""
    K, B = 256, 256
    jstage = jkw.KeyedSessionWindowStage(100, SPECS, 8)
    tstage = tkw.KeyedSessionWindowStage(100, SPECS, 8)
    rng = np.random.default_rng(31)
    feed = []
    # 200 keys open sessions; key 7 breaks twice inside the batch
    pk = np.concatenate([np.arange(200), np.full(56, 7)]).astype(np.int32)
    ts = np.concatenate([np.full(200, 1000), 1000 + 150 * np.arange(1, 57)]).astype(np.int64)
    o = np.argsort(ts, kind="stable")
    pk, ts = pk[o], ts[o]
    cols = {"__type__": np.zeros(B, np.int8), "__valid__": np.ones(B, bool),
            "__ts__": ts, "__gk__": pk, "__pk__": pk, "v": rng.standard_normal(B),
            "v?": np.zeros(B, bool), "n": rng.integers(0, 9, B),
            "n?": np.zeros(B, bool), "ck": ts, "ck?": np.zeros(B, bool)}
    feed.append((cols, int(ts.max())))
    for now in (20000, 20000, 20001):
        feed.append(_timer_batch(B, now))
    _j, tst, emitted = _run("session", jstage, tstage, K, feed)
    assert emitted > 200
    assert int((tst["cnt"] > 0).sum()) == 0


def test_keyed_session_overflow():
    """A session longer than its buffer raises the overflow lane (the app
    raises FatalQueryError naming partition_window_capacity)."""
    jstage = jkw.KeyedSessionWindowStage(1000, SPECS, 4)
    tstage = tkw.KeyedSessionWindowStage(1000, SPECS, 4)
    feed = _batches(41, 3, 32, 16, "s", gap=(0, 10), pk_hi=2, timers=0.0,
                    invalid=0.0)
    _j, _t, _n = _run("session", jstage, tstage, 16, feed)
    out = tstage.apply(tstage.init_state(16, "cpu"), tstage.conform(_to_torch(feed[0][0])),
                       {"current_time": feed[0][1]})[1]
    assert int(out["__overflow__"]) == 1


@pytest.mark.parametrize("name", ["time", "time_length", "batch", "hopping",
                                  "time_batch"])
def test_keyed_stage_overflow_lane(name):
    """Each bounded stage raises its overflow lane past its capacity, as
    the reference does."""
    make = {
        "time": lambda m: m.KeyedTimeWindowStage(10_000, SPECS, 4),
        "time_length": lambda m: m.KeyedTimeWindowStage(10_000, SPECS, 4, max_len=2),
        "batch": lambda m: m.KeyedBatchWindowStage(SPECS, 4),
        "hopping": lambda m: m.KeyedHoppingWindowStage(10_000, 5000, SPECS, 4),
        "time_batch": lambda m: m.KeyedTimeBatchWindowStage(10_000, SPECS, 4),
    }[name]
    feed = _batches(51, 2, 32, 16, "o", pk_hi=2, timers=0.0, invalid=0.0)
    jstage, tstage = make(jkw), make(tkw)
    jst, tst = jstage.init_state(16), tstage.init_state(16, "cpu")
    jstep = jax.jit(lambda st, c, now: jstage.apply(st, c, {"xp": jnp,
                                                            "current_time": now}))
    for cols, now in feed:
        jst, jout = jstep(jst, _to_jax(cols), np.int64(now))
        tst, tout = tstage.apply(tst, tstage.conform(_to_torch(cols)),
                                 {"current_time": now})
        assert int(tout["__overflow__"]) == int(jout["__overflow__"])
    expect = 0 if name == "time_length" else 1
    assert int(tout["__overflow__"]) == expect


def test_factory_accepts_and_refuses_as_the_reference():
    """Every window the reference's keyed factory takes is taken, with the
    same stage kinds; what it refuses raises the same text."""
    from siddhi_tpu.compiler import SiddhiCompiler as JC
    from siddhi_tpu_torch.compiler import SiddhiCompiler as TC
    from siddhi_tpu_torch.ops.expressions import CompileError

    class Ctx:
        partition_window_capacity = 32
        window_capacity = 64

    def window_of(compiler, text):
        app = compiler.parse(
            "define stream S (sym string, v int, ets long); "
            f"from S#window.{text} select sym insert into O;")
        q = app.execution_elements[0]
        return app.stream_definitions["S"], q.input_stream.handlers[0]

    from siddhi_tpu.core.plan.resolvers import SingleStreamResolver as JR
    from siddhi_tpu.core.event import StringDictionary as JD
    from siddhi_tpu_torch.core.plan.resolvers import SingleStreamResolver as TR
    from siddhi_tpu_torch.core.event import StringDictionary as TD

    for text, kind in [
            ("length(3)", "KeyedLengthWindowStage"),
            ("time(1 sec)", "KeyedTimeWindowStage"),
            ("externalTime(ets, 1 sec)", "KeyedTimeWindowStage"),
            ("timeLength(1 sec, 3)", "KeyedTimeWindowStage"),
            ("delay(1 sec)", "DelayWindowStage"),
            ("lengthBatch(3)", "KeyedLengthBatchWindowStage"),
            ("timeBatch(1 sec)", "KeyedTimeBatchWindowStage"),
            ("batch()", "KeyedBatchWindowStage"),
            ("hopping(2 sec, 1 sec)", "KeyedHoppingWindowStage"),
            ("session(1 sec)", "KeyedSessionWindowStage"),
            ("session(1 sec, sym, 500 millisec)", "PartitionedHostWindow"),
            ("sort(2, v)", "PartitionedHostWindow"),
            ("frequent(2, sym)", "PartitionedHostWindow"),
            ("lossyFrequent(0.1, 0.01)", "PartitionedHostWindow"),
            ("cron('*/5 * * * * ?')", "PartitionedHostWindow"),
            ("expression('count() <= 2')", "PartitionedHostWindow"),
            ("expressionBatch('count() <= 2')", "PartitionedHostWindow"),
            ("lengthBatch(3, true)", None), ("lengthBatch(0)", None),
            ("timeBatch(1 sec, 0)", None), ("batch(4)", None),
            ("length(1, 2)", None), ("externalTimeBatch(ets, 1 sec)", None),
            ("unique:length(sym, 3)", None)]:
        results = []
        for comp, mod, res, dic in ((JC, jkw, JR, JD), (TC, tkw, TR, TD)):
            try:
                sdef, w = window_of(comp, text)
            except Exception as e:            # noqa: BLE001 — parse refusals
                results.append(("parse", type(e).__name__))
                continue
            try:
                st = mod.create_keyed_window_stage(w, sdef, res(sdef, dic()), Ctx())
                results.append(type(st).__name__)
            except Exception as e:            # noqa: BLE001 — compared below
                results.append(("error", str(e)))
        assert results[0] == results[1], (text, results)
        if kind is not None:
            assert results[1] == kind, (text, results)
