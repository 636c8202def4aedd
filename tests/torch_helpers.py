"""Shared helpers of the ``test_torch_*`` files: drive the same feed
through the JAX package (the reference) and its PyTorch port, and compare
their outputs under one tolerance rule.

Tolerance: ints, strings, timestamps, event types, row counts and row
order match exactly; floats match to rtol 1e-12, the tolerance the
reference applies between its own paths (tests/test_fused_agg.py), since
the port's segmented scan adds in another order than
``lax.associative_scan``.
"""

import contextlib

import numpy as np
import torch

torch.set_num_threads(1)

FLOAT_RTOL = 1e-12

PARTITIONED_APP = """
define stream StockStream (symbol string, price float, volume long);
partition with (symbol of StockStream)
begin
  @info(name = 'bench')
  from StockStream#window.length({W})
  select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
  insert into OutStream;
end;
"""

# tests/test_mesh_routing.py DISTINCT_GK_APP: the group-by key differs from
# the partition key, so the routed step carries it through the LUT
DISTINCT_GK_APP = """
    @app:name('routeapp')
    define stream S (symbol string, side string, price double, volume long);
    partition with (symbol of S)
    begin
      @info(name = 'q')
      from S#window.length(8)
      select symbol, side, avg(price) as ap, sum(volume) as tv
      group by side
      insert into Out;
    end;
"""


def stock_feed(seed, n_batches, batch, n_symbols, n_events=0, skew=False):
    """Columnar batches (+ single events) for StockStream. ``skew`` puts
    ~80% of rows on one symbol."""
    rng = np.random.default_rng(seed)
    syms = np.array([f"S{i}" for i in range(n_symbols)], dtype=object)
    feed, ts = [], 0
    for _ in range(n_batches):
        ids = rng.integers(0, n_symbols, batch)
        if skew:
            ids = np.where(rng.random(batch) < 0.8, 0, ids)
        cols = {"symbol": syms[ids],
                "price": (rng.random(batch) * 100.0).astype(np.float32),
                "volume": rng.integers(1, 1000, batch)}
        feed.append(("cols", cols, np.arange(ts, ts + batch, dtype=np.int64)))
        ts += batch
    for i in range(n_events):
        feed.append(("event", ts + i, [str(syms[rng.integers(0, n_symbols)]),
                                       float(rng.random() * 100.0),
                                       int(rng.integers(1, 1000))]))
    return feed


def side_feed(seed, n_batches, batch, n_symbols, n_sides, n_events=0):
    """Columnar batches (+ single events) for DISTINCT_GK_APP's stream S."""
    rng = np.random.default_rng(seed)
    syms = np.array([f"SYM{i}" for i in range(n_symbols)], dtype=object)
    sides = np.array([f"SIDE{i}" for i in range(n_sides)], dtype=object)
    feed, ts = [], 0
    for _ in range(n_batches):
        cols = {"symbol": syms[rng.integers(0, n_symbols, batch)],
                "side": sides[rng.integers(0, n_sides, batch)],
                "price": rng.random(batch) * 100.0,
                "volume": rng.integers(1, 1000, batch)}
        feed.append(("cols", cols, np.arange(ts, ts + batch, dtype=np.int64)))
        ts += batch
    for i in range(n_events):
        feed.append(("event", ts + i, [str(syms[rng.integers(0, n_symbols)]),
                                       str(sides[rng.integers(0, n_sides)]),
                                       float(i % 17) + 0.25, int(i)]))
    return feed


def make_collector(base):
    class Collector(base):
        def __init__(self):
            super().__init__()
            self.rows = []

        def receive(self, events):
            self.rows.extend((e.timestamp, tuple(e.data), e.is_expired)
                             for e in events)

    return Collector()


def send_feed(rt, stream, feed):
    h = rt.get_input_handler(stream)
    for item in feed:
        if item[0] == "cols":
            h.send_columns(item[1], timestamps=item[2])
        else:
            h.send(item[1], item[2])


@contextlib.contextmanager
def fusion(context_module, enabled):
    """Plan apps with the fused window stage on or off: the planner reads
    ``app_context.enable_fusion`` while the runtime is built, so the flag
    is set as each app context is made (as tests/test_fused_agg.py does)."""
    cls = context_module.SiddhiAppContext
    orig = cls.__init__

    def init(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        self.enable_fusion = enabled

    cls.__init__ = init
    try:
        yield
    finally:
        cls.__init__ = orig


class Run:
    """One app runtime of either package, with its output collector."""

    def __init__(self, pkg, app, out_stream, query, routed_n=None,
                 rows_per_shard=256, fused=True):
        if pkg == "jax":
            import siddhi_tpu
            from siddhi_tpu.core import context
            from siddhi_tpu.parallel.mesh import device_route_query_step, make_mesh

            self.manager = siddhi_tpu.SiddhiManager()
            self.collector = make_collector(siddhi_tpu.StreamCallback)
        else:
            import siddhi_tpu_torch
            from siddhi_tpu_torch.core import context
            from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

            self.manager = siddhi_tpu_torch.SiddhiManager(device="cpu")
            self.collector = make_collector(siddhi_tpu_torch.StreamCallback)
        with fusion(context, fused):
            self.rt = self.manager.create_siddhi_app_runtime(app)
        self.rt.add_callback(out_stream, self.collector)
        self.query = self.rt.query_runtimes[query]
        if routed_n is not None:
            device_route_query_step(self.query, make_mesh(routed_n),
                                    rows_per_shard=rows_per_shard)

    def feed(self, stream, feed):
        send_feed(self.rt, stream, feed)
        return self

    def close(self):
        self.manager.shutdown()
        return self.collector.rows


def assert_rows_match(got, want, rtol=FLOAT_RTOL, atol=0.0):
    """Event rows (timestamp, data, is_expired) under the tolerance rule
    (floats to ``rtol``, 1e-12 unless a test states its own, and ``atol``,
    0 unless a test states its own; NaN equals NaN, since both packages
    may emit it)."""
    assert len(got) == len(want), (len(got), len(want))
    for i, ((t1, d1, e1), (t2, d2, e2)) in enumerate(zip(got, want)):
        assert (t1, e1) == (t2, e2), (i, (t1, e1), (t2, e2))
        assert len(d1) == len(d2), i
        for a, b in zip(d1, d2):
            if isinstance(b, float) and isinstance(a, float):
                assert np.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True), (i, a, b)
            else:
                assert a == b and type(a) is type(b), (i, a, b)


def assert_arrays_match(got, want, what="", rtol=FLOAT_RTOL, atol=0.0):
    """numpy arrays under the tolerance rule (floats to ``rtol``/``atol``,
    rtol 1e-12 unless a test states its own)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind == "f":
        assert got.dtype.kind == "f", (what, got.dtype)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)
    else:
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
