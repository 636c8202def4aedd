"""apply_aggregators for every scan kind (distinctCount and unionSet, whose
value tables run the distinct scan, are held against the reference in
tests/test_torch_distinct.py) over int, long, float and double arguments:
the port against
the JAX package on the same state and columns. Rows mix CURRENT (add),
EXPIRED (subtract), RESET (every group restarts), TIMER and invalid rows,
and null arguments; prior state is random. Floats to rtol 1e-12 (the
port's log-step scan adds in another order than lax.associative_scan).
stdDev's double argument ``w`` and its prior state are multiples of 1/8,
so its sums are exact in any order: sqrt(sq/n - mean^2) cancels near a
zero variance and would amplify a summation-order difference without
bound. min/max are exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import assert_arrays_match

from siddhi_tpu.ops import aggregators as jagg
from siddhi_tpu.query_api.definitions import AttrType as JT
from siddhi_tpu_torch.ops import aggregators as tagg
from siddhi_tpu_torch.ops.expressions import TorchXP
from siddhi_tpu_torch.query_api.definitions import AttrType as TT

K, B = 16, 96
# (kind, argument column, its type name)
SPECS = [("sum", "n", "LONG"), ("sum", "v", "DOUBLE"), ("count", None, None),
         ("avg", "f", "FLOAT"), ("avg", "n", "LONG"),
         ("sum", "i", "INT"), ("sum", "f", "FLOAT"), ("count", "v", "DOUBLE"),
         ("stddev", "w", "DOUBLE"), ("stddev", "i", "INT"),
         ("and", "b", "BOOL"), ("or", "b", "BOOL"),
         ("min", "i", "INT"), ("max", "n", "LONG"), ("min", "f", "FLOAT"),
         ("max", "v", "DOUBLE"), ("minforever", "v", "DOUBLE"),
         ("maxforever", "i", "INT"), ("maxforever", "f", "FLOAT"),
         ("minforever", "n", "LONG")]
SLOTS = {"sum": 2, "count": 1, "avg": 2, "stddev": 3, "and": 1, "or": 1,
         "min": 2, "max": 2, "minforever": 2, "maxforever": 2}
ARG_DTYPE = {"INT": np.int32, "LONG": np.int64, "FLOAT": np.float32,
             "DOUBLE": np.float64}


def _arg_fn(col):
    if col is None:
        return None
    return lambda cols, ctx: (cols[col], cols.get(col + "?"))


def _specs(mod, types):
    out = []
    for i, (kind, col, tname) in enumerate(SPECS):
        at = getattr(types, tname) if tname else None
        out.append(mod.AggSpec(kind=kind, arg_fn=_arg_fn(col), arg_type=at,
                               out_key=f"__agg{i}__",
                               out_type=mod.agg_result_type(kind, at)))
    return out


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    types = rng.choice(np.array([0, 1], np.int8), B, p=[0.7, 0.3])
    if case == "reset":
        types[[20, 21, 60]] = 3          # two RESET epochs mid-batch
    if case == "timer":
        types[rng.random(B) < 0.15] = 2
    valid = rng.random(B) < 0.9
    gk = rng.integers(0, 6 if case == "few_groups" else K, B).astype(np.int32)
    cols = {
        "__gk__": gk, "__type__": types, "__valid__": valid,
        "__ts__": np.arange(B, dtype=np.int64),
        "n": rng.integers(-500, 500, B), "n?": rng.random(B) < 0.1,
        "v": rng.standard_normal(B) * 50, "v?": rng.random(B) < 0.1,
        "w": rng.integers(-800, 800, B) / 8.0, "w?": rng.random(B) < 0.1,
        "f": (rng.random(B) * 100).astype(np.float32), "f?": np.zeros(B, bool),
        "i": rng.integers(-1000, 1000, B).astype(np.int32), "i?": rng.random(B) < 0.1,
        "b": rng.random(B) < 0.5, "b?": rng.random(B) < 0.1,
    }
    state = {}
    for i, (kind, col, tname) in enumerate(SPECS):
        slots = SLOTS[kind]
        counts = rng.integers(0, 10, K)            # the count slot: integral
        if kind in ("min", "max", "minforever", "maxforever"):
            dt = ARG_DTYPE[tname]
            ext = (rng.integers(-900, 900, K) if np.issubdtype(dt, np.integer)
                   else rng.standard_normal(K) * 40)
            # a group with nothing folded holds the identity
            ident = jagg._identity(kind, np.dtype(dt))
            st = np.stack([np.where(counts == 0, ident, ext), counts]).astype(dt)
        elif kind in ("count", "and", "or") or (
                kind == "sum" and tname in ("LONG", "INT")):
            st = rng.integers(0, 50, (slots, K)).astype(np.int64)
        elif kind == "stddev":
            s0 = rng.integers(-800, 800, K) / 8.0
            st = np.stack([s0, s0 ** 2 + rng.integers(0, 5000, K) / 64.0,
                           counts.astype(np.float64)])
        else:
            st = rng.random((slots, K)) * 100
            st[-1] = counts
        state[f"a{i}"] = st
    return state, cols


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The reference under one jit (every case has the same shapes)."""
    specs = _specs(jagg, JT)
    return jax.jit(lambda st, c: jagg.apply_aggregators(specs, st, c,
                                                        {"xp": jnp}, K))


@pytest.mark.parametrize("case", ["mixed", "reset", "timer", "few_groups"])
def test_apply_aggregators_matches_jax(case):
    state, cols = _inputs(case)
    jst, jcols = _jax_step()({k: jnp.asarray(v) for k, v in state.items()},
                             {k: jnp.asarray(v) for k, v in cols.items()})
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    tst, tcols = tagg.apply_aggregators(
        _specs(tagg, TT), tstate,
        {k: torch.from_numpy(v.copy()) for k, v in cols.items()},
        {"xp": TorchXP("cpu")}, K)
    for i in range(len(SPECS)):
        key = f"__agg{i}__"
        assert_arrays_match(tcols[key].numpy(), np.asarray(jcols[key]), key)
        assert (key + "?" in tcols) == (key + "?" in jcols)
        if key + "?" in jcols:
            assert_arrays_match(tcols[key + "?"].numpy(),
                                np.asarray(jcols[key + "?"]), key + "?")
        assert_arrays_match(tst[f"a{i}"].numpy(), np.asarray(jst[f"a{i}"]),
                            f"state a{i}")
        assert tst[f"a{i}"] is tstate[f"a{i}"]      # updated in place


def test_unported_aggregator_is_named():
    """Every aggregator of the reference is ported; a kind outside the
    list is named in the error."""
    from siddhi_tpu_torch.ops.expressions import CompileError

    assert set(tagg.supported_aggregators()) == set(jagg.supported_aggregators())
    for kind in tagg.supported_aggregators():
        tagg.check_ported(kind)
    with pytest.raises(CompileError, match="median"):
        tagg.check_ported("median")
