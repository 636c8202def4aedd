"""The legacy host router, the sharding helpers and the routing refusal,
on the CPU.

- ``route_batch_to_shards`` + ``shard_keyed_query_step`` (the deprecated
  shim): the two cases of ``tests/test_sharding.py`` (lines 229 and 318)
  on the port's API. Over ``make_mesh(8)`` the shim's per-key rows equal
  the port's unsharded step's bit for bit, and the reference's unsharded
  step's (floats to rtol 1e-12); the router warns with the reference's
  ``DeprecationWarning`` and raises its ``FatalQueryError`` for a shard's
  overflow and for a group key other than the partition key.
- ``key_axis_sharding`` and ``batch_shardings``: the key axis of an array,
  and every batch column replicated.
- The routing refusal of a per-symbol ``lengthBatch(3)`` routed x2 has the
  reference's exact text (C.12).
"""

import warnings

import numpy as np
import pytest

from torch_helpers import FLOAT_RTOL, release_jax_programs  # noqa: F401 — autouse fixture

from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.plan.selector_plan import GK_KEY
from siddhi_tpu_torch.core.stream.junction import FatalQueryError
from siddhi_tpu_torch.ops.expressions import PK_KEY, TS_KEY, TYPE_KEY, VALID_KEY
from siddhi_tpu_torch.parallel import (
    batch_shardings, key_axis_sharding, make_mesh, route_batch_to_shards,
    shard_keyed_query_step)

APP = """
    define stream S (symbol string, price float, volume long);
    partition with (symbol of S)
    begin
      @info(name = 'q')
      from S#window.length(8)
      select symbol, avg(price) as ap, sum(volume) as tv
      insert into Out;
    end;
"""
NUM_KEYS, B, N = 40, 64, 8


def _batches():
    rng = np.random.default_rng(0)

    def make_batch(i):
        sym = rng.integers(0, NUM_KEYS, B, dtype=np.int64)
        return {
            TS_KEY: np.arange(i * B, (i + 1) * B, dtype=np.int64),
            TYPE_KEY: np.zeros(B, np.int8),
            VALID_KEY: np.ones(B, bool),
            "symbol": sym, "symbol?": np.zeros(B, bool),
            "price": (rng.random(B) * 100).astype(np.float32),
            "price?": np.zeros(B, bool),
            "volume": rng.integers(1, 1000, B, np.int64),
            "volume?": np.zeros(B, bool),
            GK_KEY: sym.astype(np.int32), PK_KEY: sym.astype(np.int32),
        }

    return [make_batch(i) for i in range(3)]


def _collect(outs, n_shards=None):
    """Per global key: (ts, type, ap, tv) of each valid row, in order."""
    rows = {}
    for out in outs:
        v = np.asarray(out[VALID_KEY])
        pk = np.asarray(out[PK_KEY])
        r_local = len(v) // (n_shards or 1)
        for j in np.nonzero(v)[0]:
            k = int(pk[j])
            if n_shards is not None:
                k = k * n_shards + j // r_local  # local id -> global
            rows.setdefault(k, []).append((
                int(out[TS_KEY][j]), int(out[TYPE_KEY][j]),
                float(out["ap"][j]), int(out["tv"][j])))
    return rows


def _unsharded_port(batches):
    import torch

    m = SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(APP)
    rt.start()
    q = rt.query_runtimes["q"]
    q.selector_plan.num_keys = 64
    q._win_keys = 64
    state = q._init_state()
    step = q.build_step_fn()
    outs = []
    for i, b in enumerate(batches):
        state, out = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                          10_000 + i)
        outs.append({k: t.numpy() for k, t in out.items()})
    m.shutdown()
    return outs


def _unsharded_reference(batches):
    import jax
    import siddhi_tpu

    m = siddhi_tpu.SiddhiManager()
    rt = m.create_siddhi_app_runtime(APP)
    rt.start()
    q = rt.query_runtimes["q"]
    q.selector_plan.num_keys = 64
    q._win_keys = 64
    state = q._init_state()
    step = jax.jit(q.build_step_fn())
    outs = []
    for i, b in enumerate(batches):
        state, out = step(state, b, np.int64(10_000 + i))
        outs.append(jax.device_get(out))
    m.shutdown()
    return outs


def test_shard_map_routed_keyed_window_matches_unsharded():
    """The host router and the shim over local ``[K/n]`` keyed state
    reproduce the unsharded per-key rows exactly."""
    batches = _batches()
    m = SiddhiManager(device="cpu")
    rt = m.create_siddhi_app_runtime(APP)
    rt.start()
    q = rt.query_runtimes["q"]
    q.selector_plan.num_keys = 16   # local capacity: ceil(40/8) -> 16
    q._win_keys = 16
    sstep, sstate = shard_keyed_query_step(q, make_mesh(8), rows_per_shard=B)
    sh = []
    for i, b in enumerate(batches):
        with pytest.warns(DeprecationWarning, match="device_route_query_step"):
            rb = route_batch_to_shards(b, 8, B)
        sstate, out = sstep(sstate, rb, np.int64(10_000 + i))
        # one (overflow, notify, count, instrument lanes...) row a shard
        assert out["__meta__"].shape[0] == N and out["__meta__"].shape[1] >= 3
        sh.append({k: t.numpy() for k, t in out.items()})
    m.shutdown()

    u, s = _collect(_unsharded_port(batches)), _collect(sh, n_shards=8)
    assert set(u) == set(s) and len(u) > NUM_KEYS // 2
    assert all(u[k] == s[k] for k in u)
    ref = _collect(_unsharded_reference(batches))
    assert set(ref) == set(s)
    for k in ref:
        assert len(ref[k]) == len(s[k])
        for a, b in zip(s[k], ref[k]):
            assert a[:2] == b[:2] and a[3] == b[3], (k, a, b)
            assert np.isclose(a[2], b[2], rtol=FLOAT_RTOL, atol=0.0), (k, a, b)


def test_route_batch_overflow_raises():
    """The router's overflow is a FatalQueryError naming its knob, and the
    router is a deprecated shim."""
    cols = {PK_KEY: np.zeros(16, np.int32), GK_KEY: np.zeros(16, np.int32),
            VALID_KEY: np.ones(16, bool)}
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with pytest.raises(DeprecationWarning):
            route_batch_to_shards(cols, 4, 16)   # shim warns
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(FatalQueryError, match="rows_per_shard"):
            route_batch_to_shards(cols, 4, 2)  # 16 rows all on shard 0 > 2
        distinct = dict(cols, **{GK_KEY: np.arange(16, dtype=np.int32)})
        with pytest.raises(FatalQueryError, match="GK == PK"):
            route_batch_to_shards(distinct, 4, 16)


def test_sharding_helpers():
    mesh = make_mesh(4)
    assert key_axis_sharding(mesh, 2, 1) == 1
    with pytest.raises(ValueError):
        key_axis_sharding(mesh, 2, 2)
    cols = {VALID_KEY: np.ones(8, bool), "v": np.zeros((8, 3))}
    assert batch_shardings(cols, mesh) == {VALID_KEY: -1, "v": -1}


def test_routing_refusal_has_the_reference_text():
    """C.12: a per-symbol ``lengthBatch(3)`` routed x2 is refused with the
    reference's exact ``CompileError`` text."""
    import siddhi_tpu
    from siddhi_tpu.ops.expressions import CompileError as RefCompileError
    from siddhi_tpu.parallel.mesh import device_route_query_step as ref_route
    from siddhi_tpu.parallel.mesh import make_mesh as ref_mesh

    from siddhi_tpu_torch.ops.expressions import CompileError
    from siddhi_tpu_torch.parallel import device_route_query_step

    app = """define stream S (sym string, v double);
        partition with (sym of S) begin
        @info(name='q') from S#window.lengthBatch(3)
        select sym, sum(v) as t insert into O;
        end;"""
    m = SiddhiManager(device="cpu")
    q = m.create_siddhi_app_runtime(app).query_runtimes["q"]
    with pytest.raises(CompileError) as port_err:
        device_route_query_step(q, make_mesh(2))
    m.shutdown()
    rm = siddhi_tpu.SiddhiManager()
    rq = rm.create_siddhi_app_runtime(app).query_runtimes["q"]
    with pytest.raises(RefCompileError) as ref_err:
        ref_route(rq, ref_mesh(2))
    rm.shutdown()
    assert str(port_err.value) == str(ref_err.value)
    assert str(port_err.value).endswith("— use shard_query_step for those")
