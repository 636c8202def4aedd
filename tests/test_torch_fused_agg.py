"""The fused sliding aggregation (``ops/fused_agg.py``): the port's
``FusedSlidingAggStage.apply`` against the JAX package's, step by step on
the same columns and state, then the global flagship (bench.py ``_APP``
at a small window) through both packages' public API, the port's fused
path against its own generic path, and the planner's fusion decision.

Tolerance. Exact mode, stage level: the float columns are multiples of
1/8 well inside 2^40, so every sum is exact in float64 in any order and
the outputs and rings must agree to rtol 1e-12 (they do bit for bit).
Fast mode (float32 slots, ``@app:precision('fast')``): random floats, and
each running value is a prefix sum plus a ring sum of at most
n = 2B + W float32 terms of magnitude at most M; recursive summation errs
by at most (n - 1) * u * n * M with u = 2^-24 (Higham), so outputs are
held to atol n^2 * u * M. Counts and booleans are exact in both modes.
App level: rtol 1e-12 (torch_helpers), float32 prices in float64 sums."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import (
    Run, assert_arrays_match, assert_rows_match, release_jax_programs,
    stock_feed)

from siddhi_tpu.ops import aggregators as jagg
from siddhi_tpu.ops import fused_agg as jfused
from siddhi_tpu.query_api.definitions import AttrType as JT
from siddhi_tpu_torch.ops import aggregators as tagg
from siddhi_tpu_torch.ops import fused_agg as tfused
from siddhi_tpu_torch.ops.expressions import TorchXP
from siddhi_tpu_torch.query_api.definitions import AttrType as TT

K, B = 16, 64
STEPS = 3
# every invertible kind: (kind, argument column, its type name)
SPECS = [("sum", "n", "LONG"), ("sum", "v", "DOUBLE"), ("count", None, None),
         ("avg", "f", "FLOAT"), ("stddev", "v", "DOUBLE"), ("and", "b", "BOOL"),
         ("or", "b", "BOOL")]
# fast mode leaves out stdDev: sqrt(var) has no absolute error bound near 0
FAST_SPECS = [s for s in SPECS if s[0] != "stddev"]
U32 = 2.0 ** -24
MAG = 100.0                     # |float argument| bound of the fast-mode feed


def _specs(mod, types, which):
    out = []
    for i, (kind, col, tname) in enumerate(which):
        at = getattr(types, tname) if tname else None
        fn = None if col is None else (
            lambda cols, ctx, c=col: (cols[c], cols.get(c + "?")))
        out.append(mod.AggSpec(kind=kind, arg_fn=fn, arg_type=at,
                               out_key=f"__agg{i}__",
                               out_type=mod.agg_result_type(kind, at)))
    return out


def _batches(seed, exact, group_by=True):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(STEPS):
        if exact:
            v = rng.integers(-800, 800, B) / 8.0
            f = (rng.integers(0, 800, B) / 8.0).astype(np.float32)
        else:
            v = (rng.random(B) * 2 - 1) * MAG
            f = (rng.random(B) * MAG).astype(np.float32)
        out.append({
            "__gk__": (rng.integers(0, K, B) if group_by
                       else np.zeros(B, np.int64)).astype(np.int32),
            "__type__": np.where(rng.random(B) < 0.1, 2, 0).astype(np.int8),
            "__valid__": rng.random(B) < 0.9,
            "__ts__": np.arange(s * B, (s + 1) * B, dtype=np.int64),
            "n": rng.integers(-500, 500, B), "n?": rng.random(B) < 0.1,
            "v": v, "v?": rng.random(B) < 0.1,
            "f": f, "f?": np.zeros(B, bool),
            "b": rng.random(B) < 0.5, "b?": rng.random(B) < 0.1,
        })
    return out


@functools.lru_cache(maxsize=None)
def _jax_stage(W, exact):
    specs = _specs(jagg, JT, SPECS if exact else FAST_SPECS)
    stage = jfused.FusedSlidingAggStage(W, specs, num_keys_ref=lambda: K,
                                        exact=exact)
    return stage, jax.jit(lambda st, c: stage.apply(st, c, {"xp": jnp}))


@pytest.mark.parametrize("W,group_by", [(24, True), (100, True), (24, False)],
                         ids=["w_lt_b", "w_gt_b", "no_group_by"])
def test_fused_stage_matches_jax_step_by_step(W, group_by):
    stage, jstep = _jax_stage(W, True)
    jst = stage.init_state(K)
    port = tfused.FusedSlidingAggStage(W, _specs(tagg, TT, SPECS),
                                       num_keys_ref=lambda: K, exact=True)
    tst = port.init_state(K, "cpu")
    ring = {k: v for k, v in tst.items()}
    for step, cols in enumerate(_batches(W + group_by, True, group_by)):
        jst, jout = jstep(jst, {k: jnp.asarray(v) for k, v in cols.items()})
        tst, tout = port.apply(tst, {k: torch.from_numpy(v.copy())
                                     for k, v in cols.items()},
                               {"xp": TorchXP("cpu")})
        assert set(tout) == set(jout)
        for k in jout:
            assert_arrays_match(tout[k].numpy(), np.asarray(jout[k]),
                                f"step {step} {k}")
        assert set(tst) == set(jst)
        for k in jst:
            assert_arrays_match(tst[k].numpy(), np.asarray(jst[k]),
                                f"step {step} ring {k}")
            assert tst[k] is ring[k]                  # updated in place


def test_fused_stage_fast_mode_matches_jax_fast_mode():
    W = 24
    _stage, jstep = _jax_stage(W, False)
    jst = _stage.init_state(K)
    port = tfused.FusedSlidingAggStage(W, _specs(tagg, TT, FAST_SPECS),
                                       num_keys_ref=lambda: K, exact=False)
    tst = port.init_state(K, "cpu")
    assert all(t.dtype == torch.float32 for k, t in tst.items()
               if k.startswith("s"))
    n = 2 * B + W
    atol = n * n * U32 * MAG
    for step, cols in enumerate(_batches(5, False)):
        jst, jout = jstep(jst, {k: jnp.asarray(v) for k, v in cols.items()})
        tst, tout = port.apply(tst, {k: torch.from_numpy(v.copy())
                                     for k, v in cols.items()},
                               {"xp": TorchXP("cpu")})
        valid = np.asarray(jout["__valid__"])
        assert_arrays_match(tout["__valid__"].numpy(), valid)
        for k in jout:
            if k.startswith("__agg"):
                assert_arrays_match(tout[k].numpy()[valid],
                                    np.asarray(jout[k])[valid],
                                    f"step {step} {k}", rtol=0.0, atol=atol)


FLAGSHIP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'bench')
from StockStream#window.length({W})
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
group by symbol
insert into OutStream;
"""


def test_global_flagship_matches_jax_and_the_generic_path():
    """bench.py ``_APP`` at W = 50 over 200 symbols: 3 batches of 512 and
    single events. The port plans it on the fused stage, as the reference
    does; both packages agree, and so does the port's generic path."""
    from siddhi_tpu_torch.ops.windows import LengthWindowStage

    app = FLAGSHIP.format(W=50)
    feed = stock_feed(seed=21, n_batches=3, batch=512, n_symbols=200, n_events=8)
    want = Run("jax", app, "OutStream", "bench").feed("StockStream", feed).close()
    assert len(want) == 3 * 512 + 8
    fused = Run("torch", app, "OutStream", "bench")
    assert isinstance(fused.query.window_stage, tfused.FusedSlidingAggStage)
    assert fused.query.window_stage.exact
    assert fused.query.selector_plan.precomputed
    assert_rows_match(fused.feed("StockStream", feed).close(), want)
    generic = Run("torch", app, "OutStream", "bench", fused=False)
    assert isinstance(generic.query.window_stage, LengthWindowStage)
    assert_rows_match(generic.feed("StockStream", feed).close(), want)


def test_fast_precision_plans_float32_slots():
    from siddhi_tpu_torch import SiddhiManager

    rt = SiddhiManager(device="cpu").create_siddhi_app_runtime(
        "@app:precision('fast')" + FLAGSHIP.format(W=8))
    stage = rt.query_runtimes["bench"].window_stage
    assert not stage.exact
    assert stage._slot_dtypes() == [torch.float32] * 4


@pytest.mark.parametrize("query,fused", [
    ("from S#window.length(5) select symbol, sum(v) as t, stdDev(v) as sd, "
     "count() as n group by symbol having t > 1.0 insert into O;", True),
    ("from S#window.length(5) select symbol, min(v) as m group by symbol "
     "insert into O;", False),
    ("from S#window.length(5) select symbol, max(v) as m, sum(v) as t "
     "insert into O;", False),
    ("from S#window.length(5) select symbol, sum(v) as t group by symbol "
     "insert all events into O;", False),
    ("from S#window.length(5)[v > 0.0] select sum(v) as t insert into O;", False),
    ("from S#window.length(5) select symbol, v insert into O;", False),
], ids=["invertible_having", "min", "max", "all_events", "post_filter",
        "no_aggregator"])
def test_fusion_decision_matches_reference(query, fused):
    import siddhi_tpu

    from siddhi_tpu_torch import SiddhiManager

    app = "define stream S (symbol string, v double, b bool);\n" \
          "@info(name = 'q')\n" + query
    port = SiddhiManager(device="cpu").create_siddhi_app_runtime(app)
    ref = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(app)
    assert isinstance(port.query_runtimes["q"].window_stage,
                      tfused.FusedSlidingAggStage) == fused
    assert isinstance(ref.query_runtimes["q"].window_stage,
                      jfused.FusedSlidingAggStage) == fused
