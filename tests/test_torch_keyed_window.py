"""KeyedLengthWindowStage.apply: the port against the JAX package on the
same state and columns (numpy inputs from fixed seeds). Covers evictions
from the ring, evictions of rows inserted earlier in the same batch,
invalid and non-CURRENT rows, partition ids at and past key capacity, and
the routed order key (RIDX -> OKEY)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import assert_arrays_match

from siddhi_tpu.ops.keyed_windows import KeyedLengthWindowStage as JaxStage
from siddhi_tpu_torch.ops.expressions import TorchXP
from siddhi_tpu_torch.ops.keyed_windows import KeyedLengthWindowStage as TorchStage

COL_SPECS = {
    "k": np.int32, "k?": np.bool_, "v": np.float64, "v?": np.bool_,
    "n": np.int64, "n?": np.bool_, "__ts__": np.int64, "__gk__": np.int32,
    "__pk__": np.int32,
}
NOW = 123_456


def _case(name, seed=0):
    """(W, K, state, cols) numpy inputs for one scenario."""
    rng = np.random.default_rng(seed)
    W, K, B = 4, 16, 64
    if name == "ring":           # keys already full: evict from the ring
        total = rng.integers(W, 3 * W, K)
        pk = rng.integers(0, K, B)
    elif name == "in_batch":     # > W arrivals per key in one batch
        total = rng.integers(0, 2, K)
        pk = rng.integers(0, 3, B)
    elif name == "invalid":
        total = rng.integers(0, 2 * W, K)
        pk = rng.integers(0, K, B)
    elif name == "capacity":     # ids at and past the last key slot (clipped)
        total = rng.integers(0, 2 * W, K)
        pk = rng.integers(K - 2, K + 3, B)
    else:                        # routed: RIDX rides in, OKEY comes out
        total = rng.integers(0, 2 * W, K)
        pk = rng.integers(0, K, B)
    buf = {}
    for k, dt in COL_SPECS.items():
        if dt == np.bool_:
            buf[k] = rng.random(K * W) < 0.2
        elif np.dtype(dt).kind == "f":
            buf[k] = rng.standard_normal(K * W) * 10
        else:
            buf[k] = rng.integers(0, 1000, K * W).astype(dt)
    state = {"buf": buf, "total": total.astype(np.int64)}
    valid = rng.random(B) < (0.6 if name == "invalid" else 0.95)
    types = np.zeros(B, np.int8)
    if name == "invalid":
        types[rng.random(B) < 0.2] = 2        # TIMER rows pass uninserted
    cols = {
        "k": rng.integers(0, 50, B).astype(np.int32), "k?": rng.random(B) < 0.1,
        "v": rng.standard_normal(B) * 5, "v?": rng.random(B) < 0.1,
        "n": rng.integers(0, 10**6, B), "n?": np.zeros(B, bool),
        "__ts__": np.arange(1000, 1000 + B, dtype=np.int64),
        "__gk__": pk.astype(np.int32), "__pk__": pk.astype(np.int32),
        "__type__": types, "__valid__": valid,
    }
    if name == "routed":
        cols["__ridx__"] = rng.permutation(4 * B)[:B].astype(np.int64)
    return W, K, state, cols


def _tree(fn, t):
    return {k: _tree(fn, v) for k, v in t.items()} if isinstance(t, dict) else fn(t)


@pytest.mark.parametrize("name", ["ring", "in_batch", "invalid", "capacity",
                                  "routed"])
def test_keyed_length_window_matches_jax(name):
    W, K, state, cols = _case(name)
    jst, jout = JaxStage(W, COL_SPECS).apply(
        _tree(jnp.asarray, state), {k: jnp.asarray(v) for k, v in cols.items()},
        {"xp": jnp, "current_time": NOW})
    tstate = _tree(lambda a: torch.from_numpy(np.array(a)), state)
    tst, tout = TorchStage(W, COL_SPECS).apply(
        tstate, {k: torch.from_numpy(np.array(v)) for k, v in cols.items()},
        {"xp": TorchXP("cpu"), "current_time": NOW})
    assert set(tout) == set(jout)
    for k in jout:
        assert_arrays_match(tout[k].numpy(), np.asarray(jout[k]), f"out {k}")
    assert_arrays_match(tst["total"].numpy(), np.asarray(jst["total"]), "total")
    for k in COL_SPECS:
        assert_arrays_match(tst["buf"][k].numpy(), np.asarray(jst["buf"][k]),
                            f"ring {k}")
    # the port updates the ring in place: the tensors it was given changed
    assert tst["buf"]["v"] is tstate["buf"]["v"]
    if name in ("ring", "in_batch"):
        evicted = (np.asarray(jout["__type__"]) == 1) & np.asarray(jout["__valid__"])
        assert evicted.any()                                    # evictions ran
