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
import gc
import sys

import numpy as np
import pytest
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


def make_query_collector(base):
    """A QueryCallback recording (timestamp, in rows, remove rows) per call,
    empty flushes included."""
    class QueryCollector(base):
        def __init__(self):
            super().__init__()
            self.calls = []

        def receive(self, timestamp, in_events, remove_events):
            self.calls.append((
                timestamp,
                [(e.timestamp, tuple(e.data), e.is_expired) for e in in_events or []],
                [(e.timestamp, tuple(e.data), e.is_expired)
                 for e in remove_events or []]))

    return QueryCollector()


class Run:
    """One app runtime of either package, with its output collector (and a
    QueryCallback collector when ``query_callback``); ``config`` is a dict
    of ``siddhi_tpu.*`` knobs."""

    def __init__(self, pkg, app, out_stream, query, routed_n=None,
                 rows_per_shard=256, fused=True, config=None,
                 query_callback=False):
        if pkg == "jax":
            import siddhi_tpu
            from siddhi_tpu.core import context
            from siddhi_tpu.core.query.callback import QueryCallback
            from siddhi_tpu.core.util.config import InMemoryConfigManager
            from siddhi_tpu.parallel.mesh import device_route_query_step, make_mesh

            self.manager = siddhi_tpu.SiddhiManager()
            self.collector = make_collector(siddhi_tpu.StreamCallback)
        else:
            import siddhi_tpu_torch
            from siddhi_tpu_torch import InMemoryConfigManager, QueryCallback
            from siddhi_tpu_torch.core import context
            from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

            self.manager = siddhi_tpu_torch.SiddhiManager(device="cpu")
            self.collector = make_collector(siddhi_tpu_torch.StreamCallback)
        if config:
            self.manager.set_config_manager(InMemoryConfigManager(dict(config)))
        with fusion(context, fused):
            self.rt = self.manager.create_siddhi_app_runtime(app)
        self.rt.add_callback(out_stream, self.collector)
        self.query = self.rt.query_runtimes[query]
        self.query_collector = None
        if query_callback:
            self.query_collector = make_query_collector(QueryCallback)
            self.rt.add_callback(query, self.query_collector)
        if routed_n is not None:
            device_route_query_step(self.query, make_mesh(routed_n),
                                    rows_per_shard=rows_per_shard)

    def feed(self, stream, feed):
        send_feed(self.rt, stream, feed)
        return self

    def close(self):
        self.manager.shutdown()
        return self.collector.rows


PLAYBACK_STOCK = ("@app:playback define stream S (symbol string, price double, "
                  "volume long, ts long);\n")


def mixed_feed(seed, n_events=24, n_batches=3, batch=16, n_symbols=4,
               gaps=(0, 1, 5, 40, 200, 700, 1500), skew=300):
    """Single events then column batches for PLAYBACK_STOCK's S, with
    timestamps that stand still, creep and jump (so timers fire between
    and inside sends) and a ``ts`` attribute within +-``skew`` ms of the
    event time (a clock that is not monotone)."""
    rng = np.random.default_rng(seed)
    syms = np.array([f"S{i}" for i in range(n_symbols)], dtype=object)
    feed, t = [], 1000
    for _ in range(n_events):
        t += int(rng.choice(gaps))
        feed.append(("event", t, [str(syms[rng.integers(0, n_symbols)]),
                                  float(np.round(rng.random() * 100, 2)),
                                  int(rng.integers(1, 100)),
                                  t + int(rng.integers(-skew, skew + 1))]))
    for _ in range(n_batches):
        t += int(rng.choice(gaps))
        ts = t + np.sort(rng.integers(0, 900, batch)).astype(np.int64)
        feed.append(("cols", {"symbol": syms[rng.integers(0, n_symbols, batch)],
                              "price": np.round(rng.random(batch) * 100, 2),
                              "volume": rng.integers(1, 100, batch),
                              "ts": ts + rng.integers(-skew, skew + 1, batch)}, ts))
        t = int(ts.max())
    return feed


def run_both(app, feed, out="O", query="q", stream="S", config=None,
             query_callback=False):
    """The same app and feed through the JAX package and the port:
    ``{pkg: (stream rows, query-callback calls or None)}``."""
    res = {}
    for pkg in ("jax", "torch"):
        r = Run(pkg, app, out, query, config=config,
                query_callback=query_callback)
        r.feed(stream, feed)
        rows = r.close()
        res[pkg] = (rows, r.query_collector.calls if query_callback else None)
    return res


def assert_both_match(app, feed, **kw):
    """``run_both``, then the port's rows (and query-callback calls) equal
    the reference's under the tolerance rule; returns the row count."""
    res = run_both(app, feed, **kw)
    assert_rows_match(res["torch"][0], res["jax"][0])
    if res["jax"][1] is not None:
        got, want = res["torch"][1], res["jax"][1]
        assert len(got) == len(want), (len(got), len(want))
        for (t1, i1, r1), (t2, i2, r2) in zip(got, want):
            assert t1 == t2, (t1, t2)
            assert_rows_match(i1, i2)
            assert_rows_match(r1, r2)
    return len(res["jax"][0])


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


# the columns of the cross-process exchange checks: 1-, 4- and 8-byte
# elements, with and without a trailing row shape
PEER_COLUMNS = ((torch.bool, ()), (torch.uint8, (3,)), (torch.int32, ()),
                (torch.float32, (2,)), (torch.int64, ()), (torch.float64, ()))


def peer_sends(P, L, Q, p):
    """Process ``p``'s send buffers ``[L, n*Q, *tail]`` (n = P*L) of every
    ``PEER_COLUMNS`` column, made from a seed with numpy (the same in
    every process that asks for them)."""
    rng = np.random.default_rng([P, L, Q, p])
    n = P * L
    out = []
    for dtype, tail in PEER_COLUMNS:
        shape = (L, n * Q) + tail
        if dtype == torch.bool:
            a = rng.integers(0, 2, shape).astype(bool)
        elif dtype.is_floating_point:
            a = rng.standard_normal(shape).astype(str(dtype).split(".")[-1])
        else:
            info = torch.iinfo(dtype)
            a = rng.integers(info.min, info.max, shape, endpoint=True,
                             dtype=str(dtype).split(".")[-1])
        out.append(torch.from_numpy(a))
    return out


def _free_jax_programs():
    jax = sys.modules.get("jax")
    if jax is not None:
        gc.collect()
        jax.clear_caches()


@pytest.fixture(autouse=True, scope="module")
def release_jax_programs():
    """Free the JAX package's compiled programs before and after a test
    module. Each XLA:CPU executable keeps memory maps of its own; a test
    worker that compiles the reference's programs for many modules would
    reach the kernel's limit of maps a process (``vm.max_map_count``),
    where the next compile crashes. A module imports this fixture to use
    it."""
    _free_jax_programs()
    yield
    _free_jax_programs()


# ------------------------------------------------- patterns and sequences

def send_multi(rt, feed):
    """Items ``(stream, ts, row)`` (one event) or ``(stream, cols, ts)``
    (a column batch with its timestamps) on several streams."""
    handlers = {}
    for stream, a, b in feed:
        h = handlers.get(stream)
        if h is None:
            h = handlers[stream] = rt.get_input_handler(stream)
        if isinstance(a, dict):
            h.send_columns(a, timestamps=b)
        else:
            h.send(a, b)


def drive(rt, fn, kwargs, sender):
    """Feed ``rt`` the feed this module's generator ``fn`` makes from
    ``kwargs``, through ``sender``: ``"send_feed"`` (stream S) or
    ``"send_multi"`` (the streams the feed names)."""
    feed = globals()[fn](**kwargs)
    if sender == "send_feed":
        send_feed(rt, "S", feed)
    else:
        send_multi(rt, feed)


def run_both_multi(app, feed, out="O", query="q", config=None):
    """``send_multi`` of ``feed`` through the JAX package and the port:
    ``{pkg: stream rows}``."""
    res = {}
    for pkg in ("jax", "torch"):
        r = Run(pkg, app, out, query, config=config)
        send_multi(r.rt, feed)
        res[pkg] = r.close()
    return res


def assert_multi_match(app, feed, **kw):
    """``run_both_multi``, then the port's rows equal the reference's under
    the tolerance rule; returns the row count."""
    res = run_both_multi(app, feed, **kw)
    assert_rows_match(res["torch"], res["jax"])
    return len(res["jax"])


def two_stream_feed(seed, streams=("A", "B"), n_items=40, n_keys=4):
    """A seeded interleaving of single events and 8-row column batches on
    ``streams``, each of schema ``(k string, v double)``: same-key
    duplicates, clocks that stand still, creep and jump past `within`
    bounds and absent deadlines. (One batch size keeps the reference to
    one compile per stream.)"""
    rng = np.random.default_rng(seed)
    keys = np.array([f"K{i}" for i in range(n_keys)], dtype=object)
    feed, t = [], 1000
    for _ in range(n_items):
        s = streams[int(rng.integers(0, len(streams)))]
        t += int(rng.choice((0, 1, 50, 300, 900, 2500)))
        if rng.random() < 0.3:
            feed.append((s, t, [str(keys[rng.integers(0, n_keys)]),
                                float(np.round(rng.random() * 10, 1))]))
            continue
        n = 8
        ts = t + np.sort(rng.integers(0, int(rng.choice([1, 40, 1200])), n)).astype(np.int64)
        feed.append((s, {"k": keys[rng.integers(0, n_keys, n)],
                         "v": np.round(rng.random(n) * 10, 1)}, ts))
        t = int(ts.max())
    return feed


def aggregation_join_feed(seed, n_items=30, n_keys=7, pers=("seconds", "minutes"),
                          triggers=None):
    """A seeded interleaving of events on ``R (k string, v double)``,
    which an incremental aggregation folds, and of trigger rows on
    ``L (k string, v double, per string)``, each asking for a duration
    of ``pers``; single events and 8-row batches, clocks that stand
    still, creep and jump across second and minute buckets. ``triggers``
    caps the sends on L (the items past it go to R)."""
    rng = np.random.default_rng(seed)
    keys = np.array([f"K{i}" for i in range(n_keys)], dtype=object)
    pers = np.array(pers, dtype=object)
    feed, t, sent = [], 1000, 0
    for _ in range(n_items):
        s = "L" if rng.random() < 0.4 else "R"
        if s == "L" and triggers is not None:
            if sent >= triggers:
                s = "R"
            else:
                sent += 1
        t += int(rng.choice((0, 1, 50, 300, 900, 2500, 61000)))
        if rng.random() < 0.3:
            row = [str(keys[rng.integers(0, n_keys)]), float(np.round(rng.random() * 10, 1))]
            feed.append((s, t, row + [str(pers[rng.integers(0, len(pers))])]
                         if s == "L" else row))
            continue
        n = 8
        ts = t + np.sort(rng.integers(0, int(rng.choice([1, 40, 1200])), n)).astype(np.int64)
        cols = {"k": keys[rng.integers(0, n_keys, n)], "v": np.round(rng.random(n) * 10, 1)}
        if s == "L":
            cols["per"] = pers[rng.integers(0, len(pers), n)]
        feed.append((s, cols, ts))
        t = int(ts.max())
    return feed


_CPU_PACKAGE = "_siddhi_tpu_torch_on_cpu"


def cpu_package():
    """The port's top-level names with a CPU ``SiddhiManager``, as a module
    (registered under ``_CPU_PACKAGE``), so code that imports
    ``SiddhiManager`` makes CPU managers."""
    import functools
    import types

    import siddhi_tpu_torch

    cpu = sys.modules.get(_CPU_PACKAGE)
    if cpu is None:
        cpu = types.ModuleType(_CPU_PACKAGE)
        cpu.__dict__.update(vars(siddhi_tpu_torch))
        cpu.SiddhiManager = functools.partial(siddhi_tpu_torch.SiddhiManager,
                                              device="cpu")
        sys.modules[_CPU_PACKAGE] = cpu
    return cpu


def port_source(src: str) -> str:
    """Python source that imports the JAX package, re-bound to the port:
    ``from siddhi_tpu import`` takes ``cpu_package()``'s names, and every
    ``from siddhi_tpu.<mod> import`` / ``import siddhi_tpu.<mod> as`` of a
    module the port keeps under the same path takes the port's."""
    import os
    import re

    cpu_package()
    for old, new in (
            ("from siddhi_tpu import", f"from {_CPU_PACKAGE} import"),
            ("from siddhi_tpu.core.util.config import", f"from {_CPU_PACKAGE} import")):
        src = src.replace(old, new)
    port_root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "siddhi_tpu_torch")

    def rebind(m):
        mod = m.group(1)
        path = os.path.join(port_root, *mod.split("."))
        if os.path.exists(path + ".py") or os.path.exists(
                os.path.join(path, "__init__.py")):
            return f"from siddhi_tpu_torch.{mod} import"
        return m.group(0)

    src = re.sub(r"from siddhi_tpu\.([\w.]+) import", rebind, src)

    def rebind_module(m):
        # `import siddhi_tpu.<mod> as x` (a monkeypatch target) likewise
        mod = m.group(1)
        path = os.path.join(port_root, *mod.split("."))
        if os.path.exists(path + ".py"):
            return f"import siddhi_tpu_torch.{mod} as"
        return m.group(0)

    return re.sub(r"import siddhi_tpu\.([\w.]+) as", rebind_module, src)


def port_corpus(name, unported=()):
    """A reference test module of a corpus, re-bound to the port: its
    ``SiddhiManager`` makes port managers on the CPU, and every name it
    imports from a module the port keeps under the same path
    (``StreamCallback``, ``QueryCallback``, ``CompileError``, the
    compiler's exceptions, ``InMemoryConfigManager``, the record-table
    SPI, ...) is the port's (``port_source``), so each scenario drives the
    port through the module's own feed and checks the module's own
    expected rows (the reference's outputs: the module asserts them of the
    reference). ``unported``: modules of the reference with no port
    counterpart that the module may still import inside test bodies the
    port does not run (those scenarios are left out of the returned
    names). Returns (module, its test function names)."""
    import functools
    import inspect
    import os
    import re
    import types

    import siddhi_tpu_torch

    path = os.path.join(os.path.dirname(__file__), name + ".py")
    with open(path) as f:
        src = port_source(f.read())

    def rebind_corpus(m):
        # a name shared from another corpus module comes from its port
        key = f"_port_corpus_{m.group(1)}"
        if key not in sys.modules:
            sys.modules[key] = port_corpus(m.group(1))[0]
        return f"from {key} import"

    src = re.sub(r"from tests\.(\w+) import", rebind_corpus, src)
    left = re.findall(r"(?:from|import) siddhi_tpu\b(?!_torch)[.\w]*", src)
    allowed = {"from siddhi_tpu.core.manager"} | {f"from {u}" for u in unported}
    assert set(left) <= allowed, (name, left)
    mod = types.ModuleType(name + "_on_port")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)  # noqa: S102 — a repo test module
    mod.SiddhiManager = functools.partial(siddhi_tpu_torch.SiddhiManager, device="cpu")
    # a scenario that builds its own reference manager is not the port's
    tests = sorted(k for k, v in vars(mod).items()
                   if k.startswith("test_") and callable(v)
                   and not inspect.signature(v).parameters
                   and "siddhi_tpu.core.manager" not in inspect.getsource(v)
                   and not any(u in inspect.getsource(v) for u in unported))
    return mod, tests


# ----------------------------------------------------- observability tier

def api(pkg):
    """The public names an observability scenario uses, from the JAX
    package (``"jax"``) or the port (``"torch"``; its managers on the
    CPU), so one scenario body runs through both."""
    import functools
    import types

    if pkg == "jax":
        import siddhi_tpu as P
        from siddhi_tpu.core.event import Event
        from siddhi_tpu.core.util.config import InMemoryConfigManager
        from siddhi_tpu.observability import costmodel, export, instruments, journey, tracing
        from siddhi_tpu.parallel import mesh
        from siddhi_tpu.resilience import FaultInjector
        from siddhi_tpu.service import SiddhiRestService

        manager = P.SiddhiManager
    else:
        import siddhi_tpu_torch as P
        from siddhi_tpu_torch import InMemoryConfigManager
        from siddhi_tpu_torch.core.event import Event
        from siddhi_tpu_torch.observability import (
            costmodel, export, instruments, journey, tracing)
        from siddhi_tpu_torch.parallel import mesh
        from siddhi_tpu_torch.resilience import FaultInjector
        from siddhi_tpu_torch.service import SiddhiRestService

        manager = functools.partial(P.SiddhiManager, device="cpu")
    return types.SimpleNamespace(
        pkg=pkg, SiddhiManager=manager, StreamCallback=P.StreamCallback,
        InMemoryConfigManager=InMemoryConfigManager, Event=Event,
        costmodel=costmodel, export=export, instruments=instruments,
        journey=journey, tracing=tracing, FaultInjector=FaultInjector,
        SiddhiRestService=SiddhiRestService,
        device_route_query_step=mesh.device_route_query_step,
        make_mesh=mesh.make_mesh)


def lane_recorder(runtime):
    """Record every data lane a runtime decodes, batch by batch: a list
    of (slot name, lanes as a tuple of ints), from the runtime's
    ``_record_instrument`` (the one sink of decoded data slots in both
    packages)."""
    got = []
    orig = runtime._record_instrument

    def record(slot, vals, telemetry):
        got.append((slot.name, tuple(int(x) for x in np.asarray(vals).reshape(-1))))
        return orig(slot, vals, telemetry)

    runtime._record_instrument = record
    return got


_PULLS = ("numpy", "item", "tolist", "cpu", "__array__", "__int__", "__float__",
          "__bool__", "__index__")


@contextlib.contextmanager
def no_tensor_reads():
    """The CPU stand-in for the reference's ``jax.transfer_guard
    ("disallow")``: inside the block, a read of a tensor's values on the
    host on THIS thread (``.numpy()``, ``.item()``, ``.cpu()``,
    ``int(t)``, ``np.asarray(t)``, ...) raises. On the card each of these
    is a device pull."""
    import threading

    me = threading.get_ident()
    saved = {n: getattr(torch.Tensor, n) for n in _PULLS}

    def guard(name, orig):
        def read(self, *a, **k):
            if threading.get_ident() == me:
                raise AssertionError(f"tensor read on the host: Tensor.{name}")
            return orig(self, *a, **k)
        return read

    for n, f in saved.items():
        setattr(torch.Tensor, n, guard(n, f))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
