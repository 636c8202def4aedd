"""The sliding time windows of ``ops/windows.py`` (time, externalTime,
timeLength, delay, hopping), held against the JAX package: whole apps
under ``@app:playback`` on the same seeded feeds (single events, then
column batches, with clock jumps that fire timers between and inside
sends), each stage step by step on the same columns, the ring overflow
naming its knob, and externalTime at B = 65,536 against numpy oracles,
built without a ``[B, B]`` or ``[Wc, B]`` tensor.

Tolerance (tests/torch_helpers.py): ints, strings, timestamps, types and
order exact; floats to rtol 1e-12."""

import bisect

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_helpers import (PLAYBACK_STOCK, assert_arrays_match,
                           assert_both_match, mixed_feed)

from siddhi_tpu_torch.ops import windows as twin

APPS = {
    "time_grouped": "from S#window.time(1 sec) select symbol, sum(volume) as v, "
                    "avg(price) as p, count() as n group by symbol "
                    "insert all events into O;",
    "time_expired": "from S#window.time(500 millisec) select symbol, price "
                    "insert expired events into O;",
    "ext_monotone": "from S#window.externalTime(ts, 1 sec) select symbol, ts, "
                    "count() as n insert all events into O;",
    "ext_shuffled": "from S#window.externalTime(ts, 700 millisec) select symbol, "
                    "sum(volume) as v group by symbol insert all events into O;",
    "time_length": "from S#window.timeLength(1 sec, 3) select symbol, "
                   "sum(volume) as v insert all events into O;",
    "delay": "from S#window.delay(600 millisec) select symbol, volume "
             "insert into O;",
    "hopping": "from S#window.hopping(2 sec, 500 millisec) select symbol, "
               "count() as n group by symbol insert all events into O;",
    "post_window_filter": "from S#window.time(1 sec)[volume > 30] select symbol, "
                          "volume insert all events into O;",
    "late_events": "from S#window.time(1 sec) select symbol, sum(volume) as v, "
                   "count() as n group by symbol insert all events into O;",
}


@pytest.mark.parametrize("name", list(APPS))
def test_time_window_apps_match_reference(name):
    # skew 0: the clock attribute is the event time itself
    feed = mixed_feed(7, skew=0 if name == "ext_monotone" else 300)
    if name == "late_events":
        # some events arrive up to 800 ms behind the clock
        rng = np.random.default_rng(8)
        feed = [(k, a - int(rng.integers(0, 800)) if k == "event" else a, b)
                if k == "event" and rng.random() < 0.3 else (k, a, b)
                for k, a, b in feed]
    n = assert_both_match(PLAYBACK_STOCK + "@info(name='q') " + APPS[name], feed,
                          config={"siddhi_tpu.window_capacity": "256"},
                          query_callback=True)
    assert n > 0


SWEEP_APPS = {
    "expired_rows": "from S#window.time(100 millisec) select symbol, volume "
                    "insert expired events into O;",
    "all_events_grouped": "from S#window.time(100 millisec) select symbol, "
                          "sum(volume) as v group by symbol "
                          "insert all events into O;",
    "rate_limited": "from S#window.time(100 millisec) select symbol, "
                    "count() as n group by symbol output last every 50 millisec "
                    "insert into O;",
    "limit_kept_sequential": "from S#window.time(100 millisec) select symbol, "
                             "volume limit 1 insert expired events into O;",
}


@pytest.mark.parametrize("name", list(SWEEP_APPS))
def test_swept_timer_chains_keep_the_reference_chunks(name):
    """Rows a millisecond apart, then a clock jump: the reference runs a
    TIMER step (a chunk) per millisecond of the chain; the port sweeps the
    chain in one step where it may and splits the output back per chain
    time. Rows and QueryCallback calls (one per chunk) are the
    reference's, a rate limiter's ticks interleave as there, and a query
    with `limit` keeps one step per timer."""
    from siddhi_tpu_torch.core.query.runtime import QueryRuntime

    rng = np.random.default_rng(3)
    feed = [("event", 1000 + i, [f"S{i % 3}", 1.0, int(rng.integers(1, 9)), 0])
            for i in range(40)]
    feed += [("event", 1500, ["S0", 1.0, 5, 0]), ("event", 1700, ["S1", 1.0, 6, 0])]
    app = PLAYBACK_STOCK + "@info(name='q') " + SWEEP_APPS[name]
    steps = [0]
    orig = QueryRuntime.process_timer

    def counted(self, ts):
        steps[0] += 1
        return orig(self, ts)

    QueryRuntime.process_timer = counted
    try:
        assert assert_both_match(app, feed, query_callback=True) > 0
    finally:
        QueryRuntime.process_timer = orig
    if name == "limit_kept_sequential":
        assert steps[0] >= 40
    else:
        # the chain of 40 timers ran in a few swept steps
        assert steps[0] < 10, steps[0]


def test_time_window_overflow_names_the_knob():
    from siddhi_tpu_torch.core.stream.junction import FatalQueryError
    from torch_helpers import Run, send_feed

    app = (PLAYBACK_STOCK + "@info(name='q') from S#window.time(1 hour) "
           "select symbol, price insert into O;")
    r = Run("torch", app, "O", "q", config={"siddhi_tpu.window_capacity": "16"})
    with pytest.raises(FatalQueryError, match="siddhi_tpu.window_capacity"):
        send_feed(r.rt, "S", mixed_feed(3, n_events=20, n_batches=1))
    r.manager.shutdown()


# ------------------------------------------------------------ stage level

SPECS = {"v": np.float64, "v?": np.bool_, "ck": np.int64, "ck?": np.bool_,
         "__ts__": np.int64, "__gk__": np.int32}


def _stage_batches(seed, steps, B, shuffle, late=False):
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for _ in range(steps):
        ts = t + rng.integers(0, 60, B)
        # late rows: timestamps out of order within a batch (the time
        # window's FIFO is then not monotone and it scans the whole ring)
        ts = (ts if late else np.sort(ts)).astype(np.int64)
        ck = ts + (rng.integers(-40, 41, B) if shuffle else 0)
        out.append(({"__type__": np.where(rng.random(B) < 0.1, 2, 0).astype(np.int8),
                     "__valid__": rng.random(B) < 0.85, "__ts__": ts,
                     "__gk__": rng.integers(0, 3, B).astype(np.int32),
                     "v": rng.standard_normal(B), "v?": rng.random(B) < 0.1,
                     "ck": ck.astype(np.int64), "ck?": np.zeros(B, bool)},
                    int(ts.max()) + int(rng.integers(0, 30))))
        t = int(ts.max()) + int(rng.integers(0, 80))
    return out


@pytest.mark.parametrize("kind", ["time", "time_late", "ext_monotone",
                                  "ext_shuffled", "time_length", "delay",
                                  "hopping"])
def test_time_stage_matches_jax_step_by_step(kind):
    import jax
    import jax.numpy as jnp

    from siddhi_tpu.ops import windows as jwin

    make = {
        "time": lambda m: m.TimeWindowStage(50, SPECS, 64),
        "time_late": lambda m: m.TimeWindowStage(50, SPECS, 64),
        "ext_monotone": lambda m: m.TimeWindowStage(50, SPECS, 64, external=True,
                                                    ts_key="ck"),
        "ext_shuffled": lambda m: m.TimeWindowStage(50, SPECS, 64, external=True,
                                                    ts_key="ck"),
        "time_length": lambda m: m.TimeLengthWindowStage(50, 6, SPECS),
        "delay": lambda m: m.DelayWindowStage(40, SPECS, 64),
        "hopping": lambda m: m.HoppingWindowStage(80, 30, SPECS, 64),
    }[kind]
    jstage, tstage = make(jwin), make(twin)
    jstep = jax.jit(lambda st, c, now: jstage.apply(
        st, c, {"xp": jnp, "current_time": now}))
    jst, tst = jstage.init_state(1), tstage.init_state(1, "cpu")
    monos = set()
    for i, (cols, now) in enumerate(_stage_batches(
            11, 12, 16, kind == "ext_shuffled", late=kind == "time_late")):
        jst, jout = jstep(jst, {k: jnp.asarray(v) for k, v in cols.items()},
                          np.int64(now))
        tst, tout = tstage.apply(tst, tstage.conform(
            {k: torch.from_numpy(v.copy()) for k, v in cols.items()}),
            {"current_time": now})
        assert set(tout) == set(jout)
        # the time windows emit the ring only up to its last expiring item,
        # delay only its released items: the valid rows (sorted first) and
        # the control lanes are compared
        n = int(np.asarray(jout["__valid__"]).sum())
        assert int(tout["__valid__"].sum()) == n
        for k in jout:
            want = np.asarray(jout[k])
            got = tout[k].numpy().reshape(np.shape(want)) if want.ndim == 0 \
                else tout[k].numpy()
            if want.ndim and kind.startswith(("time", "ext", "delay")) \
                    and kind != "time_length":
                got, want = got[:n], want[:n]
            assert_arrays_match(got, want, f"step {i} {k}")
        for path, leaf in jax.tree_util.tree_leaves_with_path(jst):
            node = tst
            for p in path:
                node = node[p.key]
            assert_arrays_match(node.numpy(), np.asarray(leaf), f"state {i} {path}")
        if "mono" in tst:
            monos.add(bool(tst["mono"]))
    if kind in ("time", "time_late"):
        # in-order rows keep the binary search; late rows take the
        # whole-ring scan
        assert monos == ({False} if kind == "time_late" else {True})


# ------------------------------------------------- externalTime at full B

def _first_later_covering_oracle(ts, valid, t):
    """First valid j > i with ts_j >= ts_i + t (B if none): a reverse sweep
    over a monotone stack of the suffix's running maxima."""
    B = len(ts)
    out = np.full(B, B, np.int64)
    pos, neg = [], []        # stack, nearest last; neg ascends to the top
    for i in range(B - 1, -1, -1):
        k = bisect.bisect_right(neg, -(int(ts[i]) + t)) - 1
        if k >= 0:
            out[i] = pos[k]
        if valid[i]:
            while neg and -neg[-1] <= ts[i]:
                neg.pop()
                pos.pop()
            pos.append(i)
            neg.append(-int(ts[i]))
    return out


class _LargestTensor(TorchDispatchMode):
    """Records the shape of every tensor an op produces."""

    def __init__(self):
        super().__init__()
        self.max_numel = 0
        self.max_ndim = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.max_numel = max(self.max_numel, o.numel())
                self.max_ndim = max(self.max_ndim, o.dim())
        return out


def test_external_time_full_width_matches_numpy_oracles():
    B, Wc, t = 65_536, 1 << 17, 1_000
    rng = np.random.default_rng(5)
    base = 10_000 + np.arange(B, dtype=np.int64) // 20   # 20,000 events/s
    specs = {"ck": np.int64, "ck?": np.bool_, "__ts__": np.int64,
             "__gk__": np.int32}
    stage = twin.TimeWindowStage(t, specs, Wc, external=True, ts_key="ck")
    state = stage.init_state(1, "cpu")
    fifo = np.zeros(0, np.int64)     # the ring's clocks, oldest first
    for step in range(3):
        ts = base + step * (B // 20)
        ck = ts + rng.integers(-400, 401, B)           # a shuffled clock
        valid = rng.random(B) < 0.97
        cols = {"__type__": np.zeros(B, np.int8), "__valid__": valid,
                "__ts__": ts, "__gk__": np.zeros(B, np.int32), "ck": ck,
                "ck?": np.zeros(B, bool)}
        tc = {k: torch.from_numpy(v.copy()) for k, v in cols.items()}
        # the covering helper against the stack oracle
        nxt = twin._first_later_covering(tc["ck"], tc["__valid__"], t).numpy()
        np.testing.assert_array_equal(nxt, _first_later_covering_oracle(ck, valid, t))
        with _LargestTensor() as probe:
            state, out = stage.apply(state, stage.conform(tc), {"current_time": 0})
        # nothing quadratic: every tensor is a column no longer than the
        # emission (ring + expired batch rows + current rows)
        assert probe.max_ndim == 1 and probe.max_numel <= Wc + 2 * B, (
            probe.max_ndim, probe.max_numel)
        # a ring row expires once the batch's running clock covers it, a
        # batch row once a later row's clock does
        run_max = np.maximum.accumulate(np.where(valid, ck, -2 ** 62))
        ring_exp = fifo <= run_max[-1] - t
        batch_exp = valid & (nxt < B)
        ov, ot = out["__valid__"].numpy(), out["__type__"].numpy()
        got = np.sort(out["ck"].numpy()[ov & (ot == 1)])
        want = np.sort(np.concatenate([fifo[ring_exp], ck[batch_exp]]))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(out["ck"].numpy()[ov & (ot == 0)], ck[valid])
        assert int(out["__overflow__"]) == 0
        # the stage drops a FIFO prefix as long as its expired rows
        fifo = np.concatenate([fifo, ck[valid]])[int(ring_exp.sum() + batch_exp.sum()):]
        assert int(state["total"] - state["expired_upto"]) == fifo.size


BAD_WINDOWS = [
    "time(2 sec, 5)", "time(volume)", "time(4.7)", "externalTime(ts)",
    "externalTime(price, 5 sec)", "externalTime('ts', 5 sec)",
    "timeLength(4 sec)", "timeLength('4 sec', 4)", "lengthBatch(2.5)",
    "timeBatch(1 sec, 'x')", "batch(-1)", "hopping(1 sec)", "delay(1 sec, 2)",
    "externalTimeBatch(ts)", "noSuchWindow(1)",
]


@pytest.mark.parametrize("window", BAD_WINDOWS)
def test_bad_window_parameters_fail_as_in_the_reference(window):
    """The factory's arity and constant checks (the reference processors'
    init validation, tests/test_window_family_corpus.py): both packages
    refuse the app with the same message."""
    import siddhi_tpu
    import siddhi_tpu_torch

    app = PLAYBACK_STOCK + f"from S#window.{window} select symbol insert into O;"
    messages = []
    for m in (siddhi_tpu.SiddhiManager(), siddhi_tpu_torch.SiddhiManager(device="cpu")):
        with pytest.raises(Exception) as err:
            m.create_siddhi_app_runtime(app)
        messages.append((type(err.value).__name__, str(err.value)))
        m.shutdown()
    assert messages[0] == messages[1]
