"""The unkeyed sliding length window (``ops/windows.LengthWindowStage``):
the port's ``apply`` against the JAX package's, step by step on the same
columns and ring, with invalid and TIMER rows mixed in, for a window
shorter than the batch (evictees from earlier rows of the same batch) and
longer than it. A window moves data only, so every column, the emission
order and the ring match exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import assert_arrays_match

from siddhi_tpu.ops import windows as jwin
from siddhi_tpu_torch.ops import windows as twin

B = 32
COL_SPECS = {"v": np.float64, "v?": np.bool_, "n": np.int64, "n?": np.bool_,
             "s": np.int32, "s?": np.bool_, "__ts__": np.int64,
             "__gk__": np.int32}


def _batches(seed, steps=4):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        out.append({
            "__type__": np.where(rng.random(B) < 0.15, 2, 0).astype(np.int8),
            "__valid__": rng.random(B) < 0.8,
            "__ts__": np.arange(s * B, (s + 1) * B, dtype=np.int64),
            "__gk__": rng.integers(0, 7, B).astype(np.int32),
            "v": rng.standard_normal(B), "v?": rng.random(B) < 0.1,
            "n": rng.integers(-99, 99, B), "n?": rng.random(B) < 0.1,
            "s": rng.integers(0, 5, B).astype(np.int32), "s?": np.zeros(B, bool),
        })
    return out


@functools.lru_cache(maxsize=None)
def _jax_stage(W):
    stage = jwin.LengthWindowStage(W, COL_SPECS)
    return stage, jax.jit(lambda st, c, now: stage.apply(
        st, c, {"xp": jnp, "current_time": now}))


@pytest.mark.parametrize("W", [12, 50], ids=["w_lt_b", "w_gt_b"])
def test_length_window_matches_jax_step_by_step(W):
    stage, jstep = _jax_stage(W)
    jst = stage.init_state(1)
    port = twin.LengthWindowStage(W, COL_SPECS)
    tst = port.init_state(1, "cpu")
    bufs = dict(tst["buf"])
    for step, cols in enumerate(_batches(W)):
        now = 1000 + step
        jst, jout = jstep(jst, {k: jnp.asarray(v) for k, v in cols.items()},
                          np.int64(now))
        tcols = port.conform({k: torch.from_numpy(v.copy())
                              for k, v in cols.items()})
        tst, tout = port.apply(tst, tcols, {"current_time": now})
        assert set(tout) == set(jout)
        for k in jout:
            assert_arrays_match(tout[k].numpy(), np.asarray(jout[k]),
                                f"step {step} {k}")
        assert int(tst["total"]) == int(jst["total"]) and tst["total"].dim() == 0
        for k in jst["buf"]:
            assert_arrays_match(tst["buf"][k].numpy(), np.asarray(jst["buf"][k]),
                                f"step {step} ring {k}")
            assert tst["buf"][k] is bufs[k]           # written in place
    # the window really evicted, from the ring and from the same batch
    assert int(tst["total"]) > W


def test_unported_window_is_named():
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.ops.expressions import CompileError

    m = SiddhiManager(device="cpu")
    with pytest.raises(
            CompileError,
            match="window 'externalTimeBatch' inside a partition is not implemented"):
        m.create_siddhi_app_runtime(
            "define stream S (k string, a int, t long); partition with (k of S) "
            "begin from S#window.externalTimeBatch(t, 1 sec) select a insert into "
            "O; end;")
