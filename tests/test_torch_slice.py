"""The port's first slice end to end through the public API, against the
JAX package: the partitioned flagship (bench.py ``_PARTITIONED_APP`` at a
small window) run four ways — JAX unrouted, JAX routed at 4 devices, the
port unrouted, the port routed at 4 logical shards — must agree under the
tolerance rule of ``torch_helpers``. Also the distinct-group-key app (the
LUT path) and a skewed feed that splits batches host-side."""

import pytest
import torch
from torch_helpers import (
    DISTINCT_GK_APP,
    PARTITIONED_APP,
    Run,
    assert_rows_match,
    side_feed,
    stock_feed,
)

APP_W8 = PARTITIONED_APP.format(W=8)


def _four_ways(app, stream, out, query, feed, rows_per_shard):
    runs = {}
    for pkg in ("jax", "torch"):
        for routed in (None, 4):
            r = Run(pkg, app, out, query, routed_n=routed,
                    rows_per_shard=rows_per_shard)
            runs[(pkg, routed)] = (r, r.feed(stream, feed).close())
    return runs


def test_partitioned_flagship_four_ways_agree():
    # 100 symbols outgrow the first routed capacity (4 shards x 16 keys):
    # the routed state is re-laid out mid-feed through its canonical form
    feed = stock_feed(seed=1, n_batches=6, batch=256, n_symbols=100, n_events=24)
    runs = _four_ways(APP_W8, "StockStream", "OutStream", "bench", feed, 256)
    want = runs[("jax", None)][1]
    assert len(want) == 6 * 256 + 24
    for key, (_r, rows) in runs.items():
        assert_rows_match(rows, want)
    # the routed runs really routed: 4 shards, grown, no route overflow
    layout = runs[("torch", 4)][0].query._route_layout
    assert layout.n == 4 and layout.local_win == 32 and layout.localK == 32
    assert layout.route_overflow_rows == 0


def test_distinct_group_key_app_agrees():
    """group by side != partition key: GK crosses the exchange through the
    host-kept LUT (routed step's local/global id rewrite)."""
    feed = side_feed(seed=2, n_batches=3, batch=256, n_symbols=13,
                     n_sides=5, n_events=16)
    runs = _four_ways(DISTINCT_GK_APP, "S", "Out", "q", feed, 256)
    want = runs[("jax", None)][1]
    assert len(want) == 3 * 256 + 16
    for _key, (_r, rows) in runs.items():
        assert_rows_match(rows, want)
    assert runs[("torch", 4)][0].query._route_layout.use_lut


def test_skewed_feed_splits_batches_and_agrees():
    """80% of rows on one symbol overflow the per-pair quota (rows_per_shard
    64 -> 16 rows per pair): prepare_routed_batches splits host-side, and
    output still equals the unrouted run."""
    from siddhi_tpu_torch.parallel import mesh as tmesh

    feed = stock_feed(seed=3, n_batches=2, batch=128, n_symbols=16, skew=True)
    jax_plain = Run("jax", APP_W8, "OutStream", "bench").feed(
        "StockStream", feed).close()
    port = Run("torch", APP_W8, "OutStream", "bench", routed_n=4,
               rows_per_shard=64)
    pieces = []
    real = tmesh.prepare_routed_batches

    def spy(runtime, cols):
        out = real(runtime, cols)
        pieces.append(len(out))
        return out

    tmesh.prepare_routed_batches = spy
    try:
        rows = port.feed("StockStream", feed).close()
    finally:
        tmesh.prepare_routed_batches = real
    assert max(pieces) > 1, pieces          # at least one batch was split
    assert_rows_match(rows, jax_plain)


@pytest.mark.parametrize("exchange", ["all_to_all", "pallas_ring"])
def test_both_exchange_knob_values_route_through_ring_exchange(exchange):
    """Both shard_exchange values take the ring_exchange_cols wrapper (on
    one card the exchange has one transport): one call per routed dispatch,
    carrying every column of the dispatch plus the row index ``__ridx__``.
    On CPU tensors it runs the plain version and counts no kernel launch."""
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.ops import exchange as ex
    from siddhi_tpu_torch.ops.expressions import RIDX_KEY
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    m = SiddhiManager(device="cpu")
    m.set_config_manager(InMemoryConfigManager(
        {"siddhi_tpu.shard_exchange": exchange}))
    rt = m.create_siddhi_app_runtime(APP_W8)
    q = rt.query_runtimes["bench"]
    device_route_query_step(q, make_mesh(4), rows_per_shard=256)
    assert q._route_layout.exchange == exchange
    dispatched, calls = [], []
    real_step, real = q._step, ex.ring_exchange_cols

    def step_spy(state, cols, now):
        dispatched.append(set(cols))
        return real_step(state, cols, now)

    def spy(bufs, n):
        calls.append((len(bufs), n, bufs[-1].dtype))
        return real(bufs, n)

    import siddhi_tpu_torch.parallel.mesh as tmesh

    q._step = step_spy
    tmesh.ring_exchange_cols = spy
    before = ex.ring_exchange.launches
    try:
        h = rt.get_input_handler("StockStream")
        h.send(0, ["S1", 1.0, 2])
        h.send(1, ["S2", 3.0, 4])
    finally:
        tmesh.ring_exchange_cols = real
    m.shutdown()
    assert len(dispatched) == 2 and q._route_layout.dispatches == 2
    assert RIDX_KEY not in set().union(*dispatched)
    # one call per dispatch: every column of the dispatch, then __ridx__
    assert calls == [(len(cols) + 1, 4, torch.int64) for cols in dispatched]
    assert ex.ring_exchange.launches == before      # CPU tensors: plain version
