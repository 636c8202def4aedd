"""distinctCount and unionSet: the port's distinct scan against the JAX
package's ``lax.scan`` (siddhi_tpu/ops/aggregators.py ``_apply_distinct``).

Module level: ``apply_aggregators`` of both packages on the same columns
and state, made with numpy from a seed. Rows mix CURRENT, EXPIRED, RESET,
TIMER and invalid rows and null arguments; values are int, long, float,
double (with -0.0 and 0.0, told apart by bit pattern), string ids and
set codes, with a multi-element set input (Cin > 1) for unionSet; the
carried-in state has stale stamps (groups whose table reads as empty) and
a nonzero epoch base; H = 4 overflows. New state (``vk``, ``vc``,
``stamp``, ``eb``), the live counts and the ``[R, H]`` companions must be
exactly equal. App level: a partitioned keyed-length query with
distinctCount, and the overflow ``FatalQueryError`` naming the knob.

One-group chains at H = 1,024 and 2,048 (the emission of a length
window, with RESETs, dead writes, hash churn through more than 4H
values, overflow, -0.0 and 0.0): the reference's ``apply_aggregators``,
the port's plain scan and the host oracle of ``chip_smoke.py``
(``scan_oracle``, a dict and a heap per group) all exactly equal.

The CUDA kernel is held against the plain version on the card
(``cuda``-marked tests, skipped here). jax is imported only inside the
reference comparisons, so the card-side run needs neither jax nor the
reference's conftest:
``pytest --noconftest -m cuda tests/test_torch_distinct.py``."""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_helpers import Run, assert_arrays_match, assert_rows_match

from siddhi_tpu_torch.ops import aggregators as tagg
from siddhi_tpu_torch.ops import distinct as tdist
from siddhi_tpu_torch.ops.distinct import distinct_scan, distinct_scan_plain
from siddhi_tpu_torch.ops.expressions import TorchXP

K, B = 12, 80
# (case, kind, argument column, its type name, H)
CASES = [
    ("long", "distinctcount", "n", "LONG", 8),
    ("int", "distinctcount", "i", "INT", 8),
    ("double", "distinctcount", "v", "DOUBLE", 8),
    ("float", "distinctcount", "f", "FLOAT", 8),
    ("string", "distinctcount", "s", "STRING", 8),
    ("overflow", "distinctcount", "n", "LONG", 4),
    ("union", "unionset", "o", "OBJECT", 8),
    ("union_multi", "unionset", "m", "OBJECT", 8),
    ("union_overflow", "unionset", "m", "OBJECT", 4),
]
CASE_IDS = [c[0] for c in CASES]


def _arg_fn(col):
    return lambda cols, ctx: (cols[col], cols.get(col + "?"))


def _spec(mod, types, kind, col, tname, H):
    at = getattr(types, tname)
    spec = mod.AggSpec(kind=kind, arg_fn=_arg_fn(col), arg_type=at,
                       out_key="__agg0__", out_type=mod.agg_result_type(kind, at),
                       distinct_capacity=H)
    if kind == "unionset":
        spec.arg_key = col
        spec.arg_is_multi = col == "m"
    return spec


def _inputs(case, H, seed=0):
    """Columns of one emitted batch and a carried-in state, numpy."""
    rng = np.random.default_rng(seed + sum(map(ord, case)))
    types = rng.choice(np.array([0, 1], np.int8), B, p=[0.6, 0.4])
    types[[17, 18, 55]] = 3                      # RESET epochs mid-batch
    types[rng.random(B) < 0.05] = 2              # TIMER rows
    valid = rng.random(B) < 0.92
    universe = 6 if "overflow" in case else 10   # few values: many matches
    cols = {
        "__gk__": rng.integers(0, K, B).astype(np.int32),
        "__type__": types, "__valid__": valid,
        "__ts__": np.arange(B, dtype=np.int64),
        "n": rng.integers(-3, universe - 3, B), "n?": rng.random(B) < 0.1,
        "i": rng.integers(0, universe, B).astype(np.int32), "i?": rng.random(B) < 0.1,
        "v": rng.choice(np.array([0.0, -0.0, 1.5, 2.5, -7.25, 1e300]), B),
        "v?": rng.random(B) < 0.1,
        "f": rng.choice(np.array([0.0, -0.0, 0.5, 3.25], np.float32), B),
        "f?": np.zeros(B, bool),
        "s": rng.integers(0, universe, B).astype(np.int32), "s?": rng.random(B) < 0.1,
        "o": rng.integers(0, universe, B).astype(np.int64), "o?": rng.random(B) < 0.1,
        # a multi-element set column: its live count plus [B, 3] elements
        "m#set": rng.integers(0, universe, (B, 3)).astype(np.int64),
        "m#setm": rng.random((B, 3)) < 0.7,
    }
    cols["m"] = cols["m#setm"].sum(1).astype(np.int64)
    cols["m?"] = np.zeros(B, bool)
    eb = 5
    # carried-in state: live, dead and never-used slots; stamps at the
    # current epoch base (live tables), before it (stale: read as empty)
    state = {
        "vk": rng.integers(0, universe, (K, H)).astype(np.int64),
        "vc": rng.choice(np.array([-1, 0, 1, 2], np.int32), (K, H)),
        "stamp": np.where(rng.random(K) < 0.7, eb, eb - 2).astype(np.int64),
        "eb": np.int64(eb),
    }
    return {"a0": state}, cols


@functools.lru_cache(maxsize=None)
def _jax_step(case):
    import jax
    import jax.numpy as jnp

    from siddhi_tpu.ops import aggregators as jagg
    from siddhi_tpu.query_api.definitions import AttrType as JT

    _c, kind, col, tname, H = CASES[CASE_IDS.index(case)]
    specs = [_spec(jagg, JT, kind, col, tname, H)]
    return jax.jit(lambda st, c: jagg.apply_aggregators(specs, st, c,
                                                        {"xp": jnp}, K))


def _port(case, state, cols):
    from siddhi_tpu_torch.query_api.definitions import AttrType as TT

    _c, kind, col, tname, H = CASES[CASE_IDS.index(case)]
    tstate = {"a0": {k: torch.from_numpy(np.array(v)) for k, v in state["a0"].items()}}
    tst, tcols = tagg.apply_aggregators(
        [_spec(tagg, TT, kind, col, tname, H)], tstate,
        {k: torch.from_numpy(v.copy()) for k, v in cols.items()},
        {"xp": TorchXP("cpu")}, K)
    return tstate, tst, tcols


@pytest.mark.parametrize("case", CASE_IDS)
def test_distinct_matches_jax_exactly(case):
    import jax.numpy as jnp

    H = CASES[CASE_IDS.index(case)][4]
    state, cols = _inputs(case, H)
    jst, jcols = _jax_step(case)(
        {"a0": {k: jnp.asarray(v) for k, v in state["a0"].items()}},
        {k: jnp.asarray(v) for k, v in cols.items()})
    tstate, tst, tcols = _port(case, state, cols)
    for k in ("vk", "vc", "stamp", "eb"):
        assert_arrays_match(tst["a0"][k].numpy(), np.asarray(jst["a0"][k]), k)
        assert tst["a0"][k] is tstate["a0"][k]          # updated in place
    for k in ("__agg0__", "__agg0__#set", "__agg0__#setm", "__agg_overflow__"):
        assert (k in tcols) == (k in jcols), k
        if k in jcols:
            assert_arrays_match(tcols[k].numpy(), np.asarray(jcols[k]), k)
    overflowed = int(np.asarray(jcols["__agg_overflow__"]))
    assert overflowed == ("overflow" in case)


def test_multi_set_without_companions_raises():
    from siddhi_tpu_torch.ops.expressions import CompileError
    from siddhi_tpu_torch.query_api.definitions import AttrType as TT

    state, cols = _inputs("union_multi", 8)
    del cols["m#set"], cols["m#setm"]
    with pytest.raises(CompileError, match="companions"):
        tagg.apply_aggregators(
            [_spec(tagg, TT, "unionset", "m", "OBJECT", 8)],
            {"a0": {k: torch.from_numpy(np.array(v)) for k, v in state["a0"].items()}},
            {k: torch.from_numpy(v.copy()) for k, v in cols.items()},
            {"xp": TorchXP("cpu")}, K)


# the shapes of tests/test_distinct_count.py whose windows are ported
_rng = np.random.default_rng(31)
APP_CASES = {
    "sliding_window": (
        "define stream S (sym string); from S#window.length(3) "
        "select distinctCount(sym) as d insert into OutStream;",
        [[s] for s in "aabcca"]),
    "group_by": (
        "define stream S (user string, page string); from S#window.length(4) "
        "select user, distinctCount(page) as d group by user "
        "insert into OutStream;",
        [["u1", "home"], ["u1", "cart"], ["u2", "home"], ["u1", "home"],
         ["u2", None], ["u2", "x"]]),
    "numeric_values": (
        "define stream S (v double); from S#window.length(10) "
        "select distinctCount(v) as d insert into OutStream;",
        [[v] for v in [1.5, 1.5, 2.5, -0.0, 0.0, None, 2.5]]),
    "differential_random": (
        "define stream S (sym string); from S#window.length(5) "
        "select distinctCount(sym) as d insert into OutStream;",
        [[f"k{int(i)}"] for i in _rng.integers(0, 6, 120)]),
    # 37 groups outgrow the initial 16 key slots: the tables grow (new
    # rows never used, vc -1, stamp 0) with their old rows kept
    "capacity_growth": (
        "define stream S (user string, page long); from S#window.length(8) "
        "select user, distinctCount(page) as d, unionSet(createSet(page)) "
        "as u group by user insert into OutStream;",
        [[f"u{int(u)}", int(p)] for u, p in zip(_rng.integers(0, 37, 90),
                                                _rng.integers(0, 4, 90))]),
    "unbounded_cardinality": (
        "define stream S (sym string); from S#window.length(3) "
        "select distinctCount(sym) as d insert into OutStream;",
        [[f"v{i}"] for i in range(70)]),
}


@pytest.mark.parametrize("case", sorted(APP_CASES))
def test_distinct_count_apps_agree(case):
    app, rows = APP_CASES[case]
    feed = [("event", i, r) for i, r in enumerate(rows)]
    want = Run("jax", app, "OutStream", "query_1").feed("S", feed).close()
    got = Run("torch", app, "OutStream", "query_1").feed("S", feed).close()
    assert len(got) == len(rows)
    assert_rows_match(got, want)


PARTITIONED_DISTINCT = """
define stream S (symbol string, page string, v long);
partition with (symbol of S)
begin
  @info(name = 'q')
  from S#window.length(3)
  select symbol, distinctCount(page) as pages, distinctCount(v) as vals
  insert into Out;
end;
"""


def _page_feed(seed, n_batches, batch):
    rng = np.random.default_rng(seed)
    syms = np.array([f"S{i}" for i in range(7)], dtype=object)
    pages = np.array([f"p{i}" for i in range(5)], dtype=object)
    feed, ts = [], 0
    for _ in range(n_batches):
        feed.append(("cols", {"symbol": syms[rng.integers(0, 7, batch)],
                              "page": pages[rng.integers(0, 5, batch)],
                              "v": rng.integers(0, 4, batch)},
                     np.arange(ts, ts + batch, dtype=np.int64)))
        ts += batch
    feed += [("event", ts + i, ["S1", f"p{i % 3}", i % 2]) for i in range(6)]
    return feed


def test_partitioned_keyed_length_distinct_count_agrees():
    feed = _page_feed(3, 3, 96)
    want = Run("jax", PARTITIONED_DISTINCT, "Out", "q").feed("S", feed).close()
    got = Run("torch", PARTITIONED_DISTINCT, "Out", "q").feed("S", feed).close()
    assert len(got) == 3 * 96 + 6
    assert_rows_match(got, want)


def test_overflow_raises_fatal_naming_the_knob():
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.stream.junction import FatalQueryError

    m = SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(
        "define stream S (v long); from S#window.length(100) "
        "select distinctCount(v) as d insert into OutStream;")
    q = next(iter(rt.query_runtimes.values()))
    for spec in q.selector_plan.specs:
        spec.distinct_capacity = 4
    h = rt.get_input_handler("S")
    with pytest.raises(FatalQueryError, match="app_context.distinct_values_capacity"):
        for v in range(10):                  # 10 live values > 4 slots
            h.send([v])
    m.shutdown()


def test_routed_distinct_is_refused():
    from siddhi_tpu_torch.ops.expressions import CompileError
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    run = Run("torch", PARTITIONED_DISTINCT, "Out", "q")
    with pytest.raises(CompileError, match="distinctcount"):
        device_route_query_step(run.query, make_mesh(4), rows_per_shard=64)
    run.close()


def _scan_inputs(seed, K_, H, R, n_values, cin=0, device="cpu"):
    """Random scan inputs in the wrapper's own terms, on ``device``."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    state = (t(rng.integers(0, n_values, (K_, H)).astype(np.int64)),
             t(rng.choice(np.array([-1, 0, 1, 3], np.int32), (K_, H))),
             t(rng.choice(np.array([4, 6]), K_).astype(np.int64)))
    epoch = np.cumsum(rng.random(R) < 0.01).astype(np.int64) + 4
    rows = (t(rng.integers(0, K_, R).astype(np.int64)),
            t(rng.integers(0, n_values, R).astype(np.int64)),
            t(np.where(rng.random(R) < 0.6, 1, -1).astype(np.int32)),
            t(rng.random(R) < 0.9), t(epoch))
    sets = ((t(rng.integers(0, n_values, (R, cin)).astype(np.int64)),
             t(rng.random((R, cin)) < 0.6)) if cin else (None, None))
    return state, rows, sets


def test_plain_scan_is_sequential():
    """The round-based plain version equals a row-at-a-time loop of the
    rules in ops/distinct.py (the reference's scan body, in Python)."""
    (vk, vc, stamp), (g, v, d, p, e), _ = _scan_inputs(1, 5, 6, 120, 9)
    vk0, vc0, st0 = vk.clone(), vc.clone(), stamp.clone()
    nd, snap_vk, snap_live, ov = distinct_scan_plain(vk, vc, stamp, g, v, d, p, e,
                                                     emit_set=True)
    want_nd, want_ov = [], False
    for i in range(g.shape[0]):
        gi = int(g[i])
        row_k, row_c = vk0[gi].clone(), vc0[gi].clone()
        view_c = torch.full_like(row_c, -1) if int(st0[gi]) != int(e[i]) else row_c
        occ = view_c > 0
        match = occ & (row_k == v[i])
        empty = ~occ
        slot = (int(match.nonzero()[0]) if match.any()
                else int(empty.nonzero()[0]) if empty.any() else None)
        after_c = view_c
        if slot is None:
            want_ov |= bool(p[i])
        elif bool(p[i]):
            after_c = view_c.clone()
            after_c[slot] = max((int(view_c[slot]) if match.any() else 0) + int(d[i]), 0)
            row_k[slot] = v[i]
            vk0[gi], vc0[gi], st0[gi] = row_k, after_c, e[i]
        want_nd.append(int((after_c > 0).sum()))
        assert torch.equal(snap_vk[i], row_k) and torch.equal(snap_live[i], after_c > 0)
    assert nd.tolist() == want_nd and bool(ov) == want_ov
    assert torch.equal(vk, vk0) and torch.equal(vc, vc0) and torch.equal(stamp, st0)


def _window_stream(rng, R, W, U, resets_within=None):
    """Types and value ids of a ``#window.length(W)`` emission over ``U``
    values: CURRENT x_t, then EXPIRED x_(t-W) once the window is full, cut
    to R rows; three RESET rows (among the first ``resets_within``), a few
    TIMER rows, and some EXPIRED rows of values that were never current
    (dead writes)."""
    x = rng.integers(0, U, R)
    x[rng.random(R) < 0.04] = 0                  # 0.0 and -0.0 often
    x[rng.random(R) < 0.04] = 1
    types, ids = [], []
    for t in range(R):
        types.append(0)
        ids.append(x[t])
        if t >= W:
            types.append(1)
            ids.append(x[t - W])
        if len(types) >= R:
            break
    types, ids = np.array(types[:R], np.int8), np.array(ids[:R], np.int64)
    dead = (types == 1) & (rng.random(R) < 0.03)
    ids[dead] = U + rng.integers(0, U, int(dead.sum()))
    types[rng.choice(resets_within or R, 3, replace=False)] = 3   # RESETs
    types[rng.random(R) < 0.01] = 2              # TIMER rows
    return types, ids


def _double_codes(ids):
    """Value ids as doubles (id 0 is 0.0 and id 1 is -0.0) and their codes,
    the int64 bit patterns the scan compares."""
    vals = ids * 0.5 + 1.0
    vals[ids == 0] = 0.0
    vals[ids == 1] = -0.0
    return vals, vals.view(np.int64)


# (case, kind, H, rows, window, values): one group of K_CHAIN; the
# overflow case has its RESETs in its first 300 rows, so that its window
# outgrows the table
CHAINS = {
    "h1024_churn": ("distinctcount", 1024, 9000, 500, 60_000),  # > 4H values
    "h1024_overflow": ("distinctcount", 1024, 4000, 2000, 60_000),
    "h2048": ("distinctcount", 2048, 5000, 1700, 4000),
    "h2048_union": ("unionset", 2048, 1500, 600, 5000),
}
K_CHAIN = 2


def _chain_cols(case):
    """Columns of one batch whose rows all fall in group 0, and a carried
    state whose table for group 0 is live (it holds values live in more
    than one slot) and for group 1 stale, numpy."""
    kind, H, R, W, U = CHAINS[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    types, ids = _window_stream(rng, R, W, U, 300 if "overflow" in case else None)
    vals, codes = _double_codes(ids)
    cols = {"__gk__": np.zeros(R, np.int32), "__type__": types,
            "__valid__": rng.random(R) < 0.99, "__ts__": np.arange(R, dtype=np.int64),
            "v": vals, "v?": rng.random(R) < 0.02,
            "o": codes.copy(), "o?": rng.random(R) < 0.02}
    _v, carried = _double_codes(rng.integers(0, U, (K_CHAIN, H)))
    state = {"vk": carried.copy(),
             "vc": rng.choice(np.array([-1, 0, 1, 2], np.int32), (K_CHAIN, H),
                              p=[0.6, 0.3, 0.05, 0.05]),
             "stamp": np.array([5, 3], np.int64), "eb": np.int64(5)}
    return {"a0": state}, cols


def _chain_spec(mod, types, case):
    kind, H = CHAINS[case][:2]
    col, tname = ("v", "DOUBLE") if kind == "distinctcount" else ("o", "OBJECT")
    return _spec(mod, types, kind, col, tname, H)


@functools.lru_cache(maxsize=None)
def _jax_chain_step(case):
    import jax
    import jax.numpy as jnp

    from siddhi_tpu.ops import aggregators as jagg
    from siddhi_tpu.query_api.definitions import AttrType as JT

    specs = [_chain_spec(jagg, JT, case)]
    return jax.jit(lambda st, c: jagg.apply_aggregators(specs, st, c,
                                                        {"xp": jnp}, K_CHAIN))


def _smoke():
    """chip_smoke.py as a module: it holds the host oracle ``scan_oracle``
    (the script imports nothing at module level but the standard library)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_chain_oracle_plain_and_reference_agree(case, monkeypatch):
    import jax.numpy as jnp

    from siddhi_tpu_torch.query_api.definitions import AttrType as TT

    state, cols = _chain_cols(case)
    jst, jcols = _jax_chain_step(case)(
        {"a0": {k: jnp.asarray(v) for k, v in state["a0"].items()}},
        {k: jnp.asarray(v) for k, v in cols.items()})
    calls = []

    def recorded(*args, **kwargs):
        calls.append(([None if a is None else a.clone() for a in args], kwargs))
        return distinct_scan(*args, **kwargs)

    monkeypatch.setattr(tagg, "distinct_scan", recorded)
    tstate = {"a0": {k: torch.from_numpy(np.array(v)) for k, v in state["a0"].items()}}
    tst, tcols = tagg.apply_aggregators(
        [_chain_spec(tagg, TT, case)], tstate,
        {k: torch.from_numpy(v.copy()) for k, v in cols.items()},
        {"xp": TorchXP("cpu")}, K_CHAIN)
    want = {k: np.asarray(v) for k, v in jcols.items()}
    for k in ("vk", "vc", "stamp", "eb"):
        assert_arrays_match(tst["a0"][k].numpy(), np.asarray(jst["a0"][k]), k)
    for k in ("__agg0__", "__agg0__#set", "__agg0__#setm", "__agg_overflow__"):
        assert (k in tcols) == (k in want), k
        if k in want:
            assert_arrays_match(tcols[k].numpy(), want[k], k)
    assert int(want["__agg_overflow__"]) == ("overflow" in case)

    (args, kwargs), = calls
    host = [t.numpy().copy() for t in args[:3]]
    nd, snap_vk, snap_live, overflow = _smoke().scan_oracle(
        *host, *[None if a is None else a.numpy() for a in args[3:]], **kwargs)
    assert np.array_equal(nd, want["__agg0__"])
    assert overflow == bool(want["__agg_overflow__"])
    if "__agg0__#set" in want:
        assert np.array_equal(snap_vk, want["__agg0__#set"])
        assert np.array_equal(snap_live, want["__agg0__#setm"])
    for k, got in zip(("vk", "vc", "stamp"), host):
        assert np.array_equal(got, np.asarray(jst["a0"][k])), k
    # the chain cycles through the table: births and deaths, dead writes
    codes = args[4].numpy()
    assert len(np.unique(codes)) > (4 * CHAINS[case][1] if "churn" in case else 0)


def test_kernel_path_by_table_size():
    assert tdist.kernel_path(1) == tdist.kernel_path(tdist.SMALL_MAX_H) == tdist.PATH_REGISTERS
    assert tdist.kernel_path(tdist.SMALL_MAX_H + 1) == tdist.PATH_HASH
    assert tdist.kernel_path(tdist.MAX_H) == tdist.PATH_HASH
    assert tdist.MAX_H >= 16384
    # above the shared-memory index: the global-index path, up to WIDE_MAX_H
    for H in (tdist.MAX_H + 1, 32768, 65536, tdist.WIDE_MAX_H - 1):
        assert tdist.kernel_path(H) == tdist.PATH_WIDE
    for H in (0, tdist.WIDE_MAX_H):
        with pytest.raises(ValueError, match="app_context.distinct_values_capacity"):
            tdist.kernel_path(H)


def _chain_inputs(seed, H, R, W, U, device, resets_within=None):
    """Scan inputs of a window stream through one group (see
    ``_window_stream``) over a live carried table, on ``device``."""
    rng = np.random.default_rng(seed)
    types, ids = _window_stream(rng, R, W, U, resets_within)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    state = (t(rng.integers(0, U, (1, H)).astype(np.int64)),
             t(rng.choice(np.array([-1, 0, 1, 2], np.int32), (1, H),
                          p=[0.6, 0.3, 0.05, 0.05])),
             t(np.full(1, 4, np.int64)))
    rows = (t(np.zeros(R, np.int64)), t(ids), t(np.where(types == 0, 1, -1).astype(np.int32)),
            t((types <= 1) & (rng.random(R) < 0.99)),
            t(np.cumsum(types == 3).astype(np.int64) + 4))
    return state, rows, (None, None)


def _kernel_equals_plain(state, rows, sets, emit, what):
    plain_state = [t.clone() for t in state]
    before = distinct_scan.launches
    got = distinct_scan(*state, *rows, *sets, emit_set=emit)
    torch.cuda.synchronize()
    assert distinct_scan.launches == before + 1
    want = distinct_scan_plain(*plain_state, *rows, *sets, emit_set=emit)
    for a, b in zip(got, want):
        assert (a is None) == (b is None), what
        if a is not None:
            assert torch.equal(a, b), what
    for a, b in zip(state, plain_state):
        assert torch.equal(a, b), what
    return bool(got[3])


@pytest.mark.cuda
def test_cuda_kernel_equals_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    dev = torch.device("cuda")
    # (K, H, R, values, Cin): random carried tables (values live in more
    # than one slot), random rows; H = 256 with many groups straddles the
    # crossover, H = 16,384 keeps its table in global memory
    shapes = [(64, 64, 5000, 40, 0), (16, 4, 800, 12, 0), (3, 100, 3000, 150, 0),
              (1, 1024, 6000, 1500, 0), (40, 64, 3000, 30, 3), (7, 8, 500, 20, 40),
              (5, 33, 700, 60, 0), (1, 1, 300, 3, 0), (1, 2048, 6000, 3000, 0),
              (1, 8192, 5000, 12000, 0), (1, 16384, 2000, 30000, 0),
              (64, 256, 8000, 300, 0), (3, 1024, 2000, 1500, 4)]
    for seed, (K_, H, R, n_values, cin) in enumerate(shapes):
        for emit in (False, True):
            state, rows, sets = _scan_inputs(seed, K_, H, R, n_values, cin, dev)
            _kernel_equals_plain(state, rows, sets, emit,
                                 (K_, H, R, n_values, cin, emit))
    # window streams through one group: churn through > 4H values, and a
    # window wider than the table
    for seed, (H, R, W, U, overflows) in enumerate(
            [(1024, 12000, 500, 60_000, False), (1024, 4000, 2000, 60_000, True),
             (8192, 8000, 3000, 60_000, False)]):
        for emit in (False, True):
            state, rows, sets = _chain_inputs(100 + seed, H, R, W, U, dev,
                                              300 if overflows else None)
            got = _kernel_equals_plain(state, rows, sets, emit, (H, R, W, U, emit))
            assert got == overflows, (H, R, W, U)


def _full_table_inputs(seed, K, H, R, device):
    """Every slot of K carried tables live (count 1, distinct values), then
    rows that expire carried values and insert new ones at random: new
    values overflow until an expiry frees a slot, and freed slots are
    reborn (churn)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    vk = np.stack([rng.permutation(4 * H)[:H] for _ in range(K)]).astype(np.int64)
    state = (t(vk), t(np.ones((K, H), np.int32)), t(np.full(K, 7, np.int64)))
    g = rng.integers(0, K, R).astype(np.int64)
    expire = rng.random(R) < 0.5
    old = vk[g, rng.integers(0, H, R)]
    new = rng.integers(4 * H, 5 * H, R).astype(np.int64)
    rows = (t(g), t(np.where(expire, old, new)),
            t(np.where(expire, -1, 1).astype(np.int32)), t(np.ones(R, bool)),
            t(np.full(R, 7, np.int64)))
    return state, rows, (None, None)


@pytest.mark.cuda
def test_cuda_wide_tables_equal_plain():
    """H above the shared-memory index (the global-index path): random
    carried tables, a set input, a window stream's churn, and full tables
    that overflow; kernel == plain, state and outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    dev = torch.device("cuda")
    for seed, (K_, H, R, n_values, cin) in enumerate(
            [(2, 32768, 3000, 40000, 0), (1, 65536, 3000, 100000, 0),
             (3, 32768, 1000, 50000, 3)]):
        for emit in (False, True):
            state, rows, sets = _scan_inputs(200 + seed, K_, H, R, n_values, cin, dev)
            _kernel_equals_plain(state, rows, sets, emit, (K_, H, R, n_values, cin, emit))
    for seed, H in enumerate((32768, 65536)):
        state, rows, sets = _chain_inputs(300 + seed, H, 6000, 3000, 60_000, dev)
        assert not _kernel_equals_plain(state, rows, sets, False, ("churn", H))
        state, rows, sets = _full_table_inputs(400 + seed, 2, H, 3000, dev)
        assert _kernel_equals_plain(state, rows, sets, seed == 0, ("full", H))


@pytest.mark.cuda
def test_cuda_h_above_the_limit_raises_naming_the_knob():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no CPU mode")
    dev = torch.device("cuda")
    H = tdist.WIDE_MAX_H
    state = (torch.zeros((1, H), dtype=torch.int64, device=dev),
             torch.full((1, H), -1, dtype=torch.int32, device=dev),
             torch.zeros(1, dtype=torch.int64, device=dev))
    rows = (torch.zeros(4, dtype=torch.int64, device=dev),
            torch.arange(4, device=dev), torch.ones(4, dtype=torch.int32, device=dev),
            torch.ones(4, dtype=torch.bool, device=dev),
            torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="app_context.distinct_values_capacity"):
        distinct_scan(*state, *rows)
