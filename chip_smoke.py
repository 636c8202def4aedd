#!/usr/bin/env python3
"""Chip smoke test of siddhi_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card     name and power limit (nvidia-smi), torch/CUDA versions;
2. build    every CUDA kernel of the port, built from ``siddhi_tpu_torch/csrc``
            with one nvcc per source started together; prints ``-Xptxas -v``;
            and the native string dictionary (``native/strdict.cpp``, g++);
3. kernels  each kernel against its plain torch version on the card at the
            shapes the routed flagship gives it (exact equality: the exchange
            is a copy): ``ring_exchange_cols`` in one call over all 13
            buffers of ``exchange_columns``, a call with odd and sub-16-byte
            segments, and a call of 65 columns that must launch twice. Then
            one routed batch's 12 columns timed with CUDA events (L2 flushed
            before each run, and warm as the first port slice timed them)
            beside the plain version, one PyTorch library call per column and
            the byte bound; the host time of one call's enqueue; the
            kernel's own device time from torch.profiler and its share of
            the bound;
4. slice    the partitioned flagship (per-symbol ``#window.length(1000)``,
            ``avg(price)``, ``sum(volume)``; 16,384 key slots, 573 MB of
            window state) routed over 4 logical shards with
            ``shard_exchange: pallas_ring``, fed 65,536-row batches of 10,000
            string symbols through ``send_columns``. Checks: the exchange
            kernel launched once per routed dispatch, no route overflow,
            routed output
            equal to an unrouted run on the card, the first two batches equal
            to the port's own CPU run (plain versions), one output row per
            input row, finite values. Prints events/s of both card runs;
5. global   the global flagship, bench.py's ``_APP`` (one
            ``#window.length(1000)`` over the whole stream, ``avg(price)``,
            ``sum(volume)`` group by symbol, 16,384 key slots), on the fused
            sliding-aggregation stage, same feed. Checks: the stage is the
            fused one in exact precision, one finite output row per input
            row, the first two batches equal the port's CPU run, all eight
            equal a card run planned without fusion (the generic window ->
            aggregator path). Prints events/s of both card runs;
6. twin     the flagship's twin, ``__graft_entry__._APP`` (``[price > 0.0]
            #window.length(128)``, avg/sum/count/min group by symbol), on the
            generic path, on the same feed with prices lowered by 15 (about
            15% fail the filter). Checks: the generic stage, rows out ==
            rows with price > 0, the first two batches equal the CPU run;
7. strdict  the native string dictionary against its plain Python probe over
            the eight batches' symbol columns (ids equal, the first batch's
            misses included); host ms per 65,536-row encode of each;
8. profile  where the routed step's and the global flagship's time goes:
            device time by torch op and the card's busy share, the sum of
            its kernels and copies (torch.profiler),
            host time by function (cProfile);
9. distinct distinctCount/unionSet and the function library, same feed:
            D1, the global flagship's shape grouped by symbol with
            ``distinctCount(volume)`` and functions (H = 64, 8 batches);
            D2, ``distinctCount(symbol)`` over the whole window (one group,
            H = 1024: one chain of every row); D3, the same over
            ``#window.length(10000)`` at H = 8192 (~6,300 symbols live);
            S, the unionSet chain createSet -> ``#window.length(1000)``
            unionSet group by symbol -> sizeOfSet (3 batches). Checks: one
            distinct-scan launch per batch, no overflow, one row out per
            row in; D1's first two batches equal the port's CPU run; D2's
            and D3's kernel == plain version on a cut of one batch and ==
            the host oracle ``scan_oracle`` on the whole batch, and every
            count equal to a numpy count of distinct symbols over the
            trailing window; S's sizes equal D1's counts row for row, and
            its first batch's unionSet companions equal the CPU run's.
            Prints state bytes and events/s of each, and the kernel at D1's,
            D2's and D3's shapes: CUDA-event ms (L2 flushed), plain ms, host
            enqueue, device ms (torch.profiler), ns per chain row, byte
            bound and share, longest chain; D1's rows through each of the
            kernel's paths at H = 32 to 256 (the crossover); a device
            profile of D1;
10. pipeline bench.py's ``bench_pipeline_curve`` app (the global flagship behind
            ``@Async(buffer.size='64')``, 16,384 key slots) at pipeline depths
            1, 4 and 8, each twice: a timed pass and a pass under
            torch.profiler and sync debug mode. Checks: output equal to phase
            5's synchronous run, the pump holding >= 2 batches in flight at
            depth > 1. Prints events/s from the first send until every row is
            out, per-batch latency (send to arrival), metas per drain, the
            card's busy share and host syncs per dispatch (with their sites);
11. pipeline-routed: the routed flagship (x4, ``pallas_ring``) behind @Async
            at depth 4: one exchange launch per routed dispatch, no route
            overflow, output equal to phase 4's routed run;
12. pipeline-distinct: D1 behind @Async at depth 4: one distinct-scan launch
            per batch, output equal to phase 9's D1;
13. ingest  the feed as wire frames (``WireEncoder`` -> ``decode_frame`` ->
            ``send_columns``) and through an ingest pool of 4: output and
            every dictionary id equal to columns ingest; host ms per batch of
            encode, decode and pack, inline and pooled;
14. onerror ``@OnError(action='stream')`` with a filter whose extension function
            raises for one symbol, present in one batch: that batch's rows
            arrive on ``!StockStream`` with ``_error``, the others flow; a
            full distinct value table still raises ``FatalQueryError``;
15. transport ``@source(type='inMemory')`` -> flagship -> ``@sink(type=
            'inMemory')`` over one batch: the sink's payloads equal a
            StreamCallback's rows;
16. D4      ``distinctCount(account)`` over ``#window.length(30000)``, one group,
            H = 32,768 (the distinct scan's global-index path), ``account``
            uniform over 100,000 ids from its own generator: one_group's
            checks (kernel == plain on a cut, == ``scan_oracle`` on a batch,
            every count == numpy's) and timings;
17. a ``{"pipeline": ..., "ingest": ...}`` line, a ``{"kernels": [...]}`` line,
    the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

Imports nothing of JAX nor of the JAX package ``siddhi_tpu``.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

APP = """
@app:name('chip_smoke')
@app:precision('exact')
define stream StockStream (symbol string, price float, volume long);
partition with (symbol of StockStream)
begin
  @info(name = 'bench')
  from StockStream#window.length({W})
  select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
  insert into OutStream;
end;
"""
# bench.py _APP (a copy): one length window over the whole stream, which
# the planner fuses into the invertible aggregators
GLOBAL_APP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'bench')
from StockStream#window.length({W})
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
group by symbol
insert into OutStream;
"""
# __graft_entry__._APP (a copy): min() keeps it on the generic path
TWIN_APP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'flagship')
from StockStream[price > 0.0]#window.length(128)
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume, count() as n,
       min(price) as minPrice
group by symbol
insert into OutStream;
"""
# pipeline phases: bench.py's bench_pipeline_curve app, behind @Async
PIPE_APP = "@Async(buffer.size='64')\n" + GLOBAL_APP
# distinct phase (9): D1, the global flagship's shape with distinctCount
# and the function library; D2, distinct symbols over the whole window;
# S, the unionSet chain of tests/test_sets.py over a length window
D1_APP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'bench')
from StockStream#window.length({W})
select symbol, distinctCount(volume) as volumes, avg(price) as avgPrice,
       ifThenElse(price > 50.0, 'high', 'low') as band,
       maximum(cast(volume, 'double'), 500.0) as volFloor,
       eventTimestamp() as ts
group by symbol insert into OutStream;
"""
D2_APP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'bench')
from StockStream#window.length({W}) select distinctCount(symbol) as distinct
insert into OutStream;
"""
# D4: distinct cards among the last 30,000 transactions (the global-index
# path of the distinct scan, H above the shared-memory index)
D4_APP = """
define stream StockStream (symbol string, price float, volume long, account long);
@info(name = 'bench')
from StockStream#window.length({W}) select distinctCount(account) as distinct
insert into OutStream;
"""
S_APP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'sets')
from StockStream select symbol, createSet(volume) as vs insert into SetStream;
@info(name = 'bench')
from SetStream#window.length({W})
select symbol, unionSet(vs) as volumes group by symbol insert into VolStream;
@info(name = 'size')
from VolStream select symbol, sizeOfSet(volumes) as n insert into OutStream;
"""
D2_H = 1024                     # ~950 symbols are live at a time
D2_CUT = 2048                   # rows of the kernel-vs-plain check at D2, D3
D3_WINDOW = 10_000              # D3: ~6,300 of the 10,000 symbols live
D3_H = 8192
D4_WINDOW = 30_000              # D4: ~25,900 of 100,000 accounts live
D4_H = 32_768
D4_ACCOUNTS = 100_000
D4_RUNS = 10
CROSSOVER_H = (32, 64, 128, 256)
CROSSOVER_RUNS = 10
S_BATCHES = 3
WINDOW = 1000
NUM_SYMBOLS = 10_000
KEY_SLOTS = 16_384
BATCH = 65_536
N_BATCHES = 8
N_SHARDS = 4
ROWS_PER_SHARD = 20_480         # B / n * 1.25, as the flagship bench routes
CPU_BATCHES = 2
TIMED_RUNS = 30
L2_FLUSH_BYTES = 100 * 2 ** 20  # written before each flushed timing (L2: 50 MB)
H100_BYTES_PER_S = 3.35e12      # HBM3 rate of one H100 SXM (data sheet)
FLOAT_RTOL = 1e-12


class Failure(Exception):
    pass


def _require(cond, msg):
    if not cond:
        raise Failure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    _require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


# ------------------------------------------------------------------ feed

def make_feed(seed: int, n_batches: int, batch: int, n_symbols: int):
    """Seeded batches in the shape of bench.py's generator: uniform symbol
    ids over ``n_symbols`` string symbols, price U(0, 100) float32, volume
    U[1, 1000) int64, per-row timestamps."""
    import numpy as np

    rng = np.random.default_rng(seed)
    syms = np.array([f"S{i}" for i in range(n_symbols)], dtype=object)
    feed = []
    for i in range(n_batches):
        ids = rng.integers(0, n_symbols, batch, dtype=np.int64)
        feed.append(({
            "symbol": syms[ids],
            "price": (rng.random(batch) * 100.0).astype(np.float32),
            "volume": rng.integers(1, 1000, batch, dtype=np.int64),
        }, np.arange(i * batch, (i + 1) * batch, dtype=np.int64)))
    return feed


def run_slice(device, feed, *, routed: bool, window: int = WINDOW,
              key_slots: int = KEY_SLOTS, n_shards: int = N_SHARDS,
              rows_per_shard: int = ROWS_PER_SHARD, on_route=None):
    """Drive the flagship through the public API on ``device``. Returns
    (per-batch output column dicts, per-batch seconds, runtime facts)."""
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager(
        {"siddhi_tpu.shard_exchange": "pallas_ring"}))
    rt = m.create_siddhi_app_runtime(APP.format(W=window))
    _require(rt.app_context.precision == "exact", "precision is not exact")
    cb = collector()
    rt.add_callback("OutStream", cb)
    q = rt.query_runtimes["bench"]
    q.selector_plan.num_keys = key_slots
    q._win_keys = key_slots
    facts = {}
    if routed:
        device_route_query_step(q, make_mesh(n_shards, device),
                                rows_per_shard=rows_per_shard)
    else:
        q._state = q._init_state()
    facts["state_bytes"] = sum(
        t.numel() * t.element_size() for t in _leaves(q._state))
    h = rt.get_input_handler("StockStream")
    if on_route is not None:
        on_route()
    seconds = send_timed(h, feed, device)
    if routed:
        facts["route_overflow"] = q._route_layout.route_overflow_rows
        facts["dispatches"] = q._route_layout.dispatches
    facts["key_slots"] = (q.selector_plan.num_keys * (n_shards if routed else 1))
    m.shutdown()
    return cb.batches, seconds, facts


def collector():
    """A stream callback that keeps each emitted batch as host columns of
    its valid rows: timestamps, types and every output attribute."""
    import threading

    import numpy as np

    from siddhi_tpu_torch import StreamCallback

    class Cols(StreamCallback):
        def __init__(self):
            self.batches = []
            self.arrivals = []      # host clock at each batch's arrival
            self.rows = 0
            self.target = None      # wait_rows: set ``reached`` at this count
            self.reached = threading.Event()

        def receive_batch(self, batch, junction):
            valid = np.asarray(batch.cols["__valid__"])
            keep = [k for k in batch.cols
                    if not k.startswith("__") or k in ("__ts__", "__type__")]
            self.batches.append({k: np.asarray(batch.cols[k])[valid] for k in keep})
            self.rows += int(valid.sum())
            self.arrivals.append(time.perf_counter())
            if self.target is not None and self.rows >= self.target:
                self.reached.set()

    return Cols()


def send_timed(h, feed, device):
    """Send every batch; per batch seconds (a send returns after its
    batch is emitted; the card is synchronised before the clock stops)."""
    import torch

    seconds = []
    for cols, ts in feed:
        t0 = time.perf_counter()
        h.send_columns(cols, timestamps=ts)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds


@contextlib.contextmanager
def fusion(enabled: bool):
    """Plan apps with the fused window stage on or off: the planner reads
    ``app_context.enable_fusion`` while the runtime is built, so the flag
    is set as each app context is made."""
    from siddhi_tpu_torch.core.context import SiddhiAppContext

    orig = SiddhiAppContext.__init__

    def init(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        self.enable_fusion = enabled

    SiddhiAppContext.__init__ = init
    try:
        yield
    finally:
        SiddhiAppContext.__init__ = orig


def global_runtime(device, app: str, query: str, fused: bool = True):
    """(manager, runtime, query runtime) of an unpartitioned app at the
    bench's key capacity (bench.py sets 16,384 slots before the feed)."""
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device=device)
    with fusion(fused):
        rt = m.create_siddhi_app_runtime(app)
    q = rt.query_runtimes[query]
    q.selector_plan.num_keys = KEY_SLOTS
    return m, rt, q


def run_global(device, app: str, query: str, feed, fused: bool = True):
    """Drive an unpartitioned app through the public API on ``device``.
    Returns (per-batch output column dicts, per-batch seconds, facts)."""
    m, rt, q = global_runtime(device, app, query, fused)
    cb = collector()
    rt.add_callback("OutStream", cb)
    facts = {"stage": type(q.window_stage).__name__,
             "precision": rt.app_context.precision,
             "exact": getattr(q.window_stage, "exact", None)}
    seconds = send_timed(rt.get_input_handler("StockStream"), feed, device)
    facts["state_bytes"] = sum(t.numel() * t.element_size()
                               for t in _leaves(q._state))
    facts["strings"] = list(rt.app_context.string_dictionary._to_str)
    m.shutdown()
    return cb.batches, seconds, facts


def require_finite(batches, what: str):
    import numpy as np

    for i, b in enumerate(batches):
        for k, v in b.items():
            if v.dtype.kind == "f":
                _require(np.all(np.isfinite(v)), f"{what}: batch {i} column {k} "
                         f"not finite")


def check_strdict(feed):
    """Native vs plain dictionary ids over the feed's symbol columns, each
    in its own fresh dictionary; host ms of each encode per batch."""
    import numpy as np

    from siddhi_tpu_torch.core.event import StringDictionary

    native, plain = StringDictionary(), StringDictionary()
    native_ms, plain_ms = [], []
    for i, (cols, _ts) in enumerate(feed):
        col = cols["symbol"]
        t0 = time.perf_counter()
        got = native.encode_array(col)
        t1 = time.perf_counter()
        want = plain.probe_array_plain(col)
        plain.resolve_missing(want, lambda j: col[j])
        t2 = time.perf_counter()
        _require(np.array_equal(got, want),
                 f"strdict: native ids differ from plain ids in batch {i}")
        native_ms.append((t1 - t0) * 1e3)
        plain_ms.append((t2 - t1) * 1e3)
    _require(native._to_str == plain._to_str, "strdict: id spaces differ")
    return native_ms, plain_ms


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def compare_outputs(a, b, what: str):
    """Ints, strings, timestamps, types and row order exactly; floats to
    rtol 1e-12 (float sums run in another order on another device)."""
    import numpy as np

    _require(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} emitted batches")
    worst = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        for k in x:
            u, v = x[k], y[k]
            _require(u.shape == v.shape,
                     f"{what}: batch {i} column {k} shape {u.shape} vs {v.shape}")
            if u.dtype.kind == "f":
                _require(np.all(np.isfinite(u)) and np.all(np.isfinite(v)),
                         f"{what}: batch {i} column {k} not finite")
                close = np.isclose(u, v, rtol=FLOAT_RTOL, atol=0.0)
                _require(close.all(), f"{what}: batch {i} column {k} differs "
                         f"beyond rtol {FLOAT_RTOL} at rows "
                         f"{np.nonzero(~close)[0][:5].tolist()}")
                denom = np.maximum(np.abs(v), 1e-300)
                worst = max(worst, float(np.max(np.abs(u - v) / denom, initial=0.0)))
            else:
                _require(np.array_equal(u, v),
                         f"{what}: batch {i} column {k} differs")
    return worst


# --------------------------------------------------------------- kernels

def exchange_columns(device):
    """One send buffer per column of the routed flagship step, at its
    shapes: [n, n*Q] with Q = rows_per_shard // n, random bytes."""
    import torch

    n, Q = N_SHARDS, ROWS_PER_SHARD // N_SHARDS
    g = torch.Generator(device="cpu").manual_seed(7)
    dtypes = {
        "symbol": torch.int32, "price": torch.float32, "volume": torch.int64,
        "__ts__": torch.int64, "__type__": torch.int8, "__valid__": torch.bool,
        "symbol?": torch.bool, "price?": torch.bool, "volume?": torch.bool,
        "__gk__": torch.int32, "__pk__": torch.int32, "__ridx__": torch.int64,
    }
    bufs = {}
    for name, dt in dtypes.items():
        if dt.is_floating_point:
            t = torch.rand((n, n * Q), generator=g, dtype=dt) * 100
        else:
            raw = torch.randint(0, 256, (n, n * Q * torch.empty(0, dtype=dt).element_size()),
                                generator=g, dtype=torch.uint8)
            t = raw % 2 == 1 if dt == torch.bool else raw.view(dt)
        bufs[name] = t.to(device).contiguous()
    # a float64 buffer too: other apps route double columns
    bufs["double"] = torch.rand((n, n * Q), generator=g, dtype=torch.float64).to(device)
    return bufs


def steady_eps(seconds, batch: int) -> float:
    """Events/s over every batch after the first (the first pays the
    card's lazy kernel loading and allocator warm-up)."""
    return batch * (len(seconds) - 1) / sum(seconds[1:])


def profile_sends(label: str, h, feed, card: str):
    """Where a path's time goes: after one warm batch, torch.profiler over
    two batches (device time by torch op, device busy share of the wall
    time) and cProfile over two more (host time by function)."""
    import cProfile
    import io
    import pstats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    h.send_columns(feed[0][0], timestamps=feed[0][1])      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for cols, ts in feed[1:3]:
            h.send_columns(cols, timestamps=ts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the profiler lists each kernel (and copy) twice: as a device event,
    # and inside the self device time of the torch op that launched it.
    # Busy time sums the device events only; the per-op table reads the ops
    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in on_card)
    op_us = sum(e.self_device_time_total for e in ops)
    _require(dev_us > 0, f"profile {label}: the profiler saw no device time")
    print(f"[profile] {label}, 2 batches: wall {wall * 1e3:.1f} ms, device busy "
          f"{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e6 / wall:.1f}% of wall; "
          f"{len(on_card)} kernel and copy names; the same time attributed to "
          f"torch ops: {op_us / 1e3:.1f} ms) [{card}]")
    top = sorted(ops, key=lambda e: -e.self_device_time_total)
    for e in top[:15]:
        print(f"[profile]   {label} device {e.self_device_time_total / 1e3:8.2f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    pr = cProfile.Profile()
    pr.enable()
    t0 = time.perf_counter()
    for cols, ts in feed[3:5]:
        h.send_columns(cols, timestamps=ts)
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    pr.disable()
    print(f"[host] {label}, 2 batches under cProfile: {host * 1e3:.1f} ms")
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(20)
    for line in buf.getvalue().splitlines():
        if line.strip():
            print(f"[host] {label} {line}")


def profile_routed(device, feed, card: str):
    """profile_sends over the routed partitioned flagship."""
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager(
        {"siddhi_tpu.shard_exchange": "pallas_ring"}))
    rt = m.create_siddhi_app_runtime(APP.format(W=WINDOW))
    q = rt.query_runtimes["bench"]
    q.selector_plan.num_keys = KEY_SLOTS
    q._win_keys = KEY_SLOTS
    device_route_query_step(q, make_mesh(N_SHARDS, device),
                            rows_per_shard=ROWS_PER_SHARD)
    profile_sends("routed", rt.get_input_handler("StockStream"), feed, card)
    m.shutdown()


def profile_global(device, feed, card: str):
    """profile_sends over the global flagship on the fused stage."""
    m, rt, _q = global_runtime(device, GLOBAL_APP.format(W=WINDOW), "bench")
    profile_sends("global", rt.get_input_handler("StockStream"), feed, card)
    m.shutdown()


def odd_columns(device):
    """Send buffers whose segments are odd byte counts, under 16 bytes, or
    over one chunk with unaligned ends: the kernel's byte path and the
    heads and tails around its bulk copies."""
    import torch

    n = N_SHARDS
    g = torch.Generator(device="cpu").manual_seed(11)
    bufs = [torch.randint(-128, 127, (n, n * 7), generator=g, dtype=torch.int8),
            torch.randint(0, 2, (n, n * 3), generator=g).bool(),
            torch.randint(-99, 99, (n, n * 5, 3), generator=g, dtype=torch.int16),
            torch.randint(-99, 99, (n, n * 7), generator=g, dtype=torch.int64),
            torch.randint(-128, 127, (n, n * 20_483), generator=g, dtype=torch.int8),
            torch.rand((n, n * 5_001), generator=g)]
    return [b.to(device) for b in bufs]


def time_ms(fn, runs: int = TIMED_RUNS, flush=None):
    """Median of ``runs`` CUDA-event timings of ``fn`` (after a warm-up).
    With ``flush`` (a large scratch tensor), it is written before each
    start event so that ``fn`` finds its inputs outside the L2 cache."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(runs):
        if flush is not None:
            flush.fill_(i & 0xFF)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, runs: int = TIMED_RUNS):
    """Mean host time of one call of ``fn``: what it takes to enqueue its
    work (host clock over ``runs`` calls, the card left to run behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / runs


def device_ms(fn, kernel: str, flush, runs: int = TIMED_RUNS, main=None):
    """Mean device time of the CUDA kernels whose names hold ``kernel``
    over ``runs`` calls of ``fn``, each after an L2 flush (torch.profiler),
    and how many launches of the call's main kernel (names holding any of
    ``main``; default ``kernel``) the profiler recorded. The profiler can
    miss a few launches of a kernel started through ctypes (on an H100 it
    saw 27 of 30 distinct-scan launches in one run), so the mean is over
    the launches it saw."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    main = (kernel,) if main is None else main
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(runs):
            flush.fill_(i & 0xFF)
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in events)
    count = sum(e.count for e in events if any(m in e.key for m in main))
    _require(0 < count <= runs and us > 0,
             f"profiler saw {count} launches of {main} with {us} us of device "
             f"time for {runs} calls")
    return us / 1e3 / count, count


def check_exchange(device):
    """Kernel vs plain: every column buffer in one call, the odd-byte call
    and the 65-column call; timings over the column set of one routed batch
    (the main path's per-dispatch exchange)."""
    import torch

    from siddhi_tpu_torch.ops.exchange import (
        ring_exchange, ring_exchange_cols, ring_exchange_cols_plain,
        ring_exchange_plain)

    n = N_SHARDS
    bufs = exchange_columns(device)
    every = list(bufs.values())
    max_err = 0.0
    got = ring_exchange_cols(every, n)
    torch.cuda.synchronize()
    for name, g, w in zip(bufs, got, ring_exchange_cols_plain(every, n)):
        _require(torch.equal(g, w), f"ring_exchange_cols differs from plain on {name}")
        if g.dtype.is_floating_point:
            max_err = max(max_err, float((g - w).abs().max()))
    odd = odd_columns(device)
    got = ring_exchange_cols(odd, n)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, ring_exchange_cols_plain(odd, n))):
        _require(torch.equal(g, w), f"ring_exchange_cols differs from plain on "
                 f"odd-byte buffer {i} {tuple(w.shape)} {w.dtype}")
    many = every * 5                        # 65 columns: two launches
    before = ring_exchange.launches
    got = ring_exchange_cols(many, n)
    torch.cuda.synchronize()
    _require(ring_exchange.launches - before == 2,
             f"{len(many)} columns took {ring_exchange.launches - before} "
             f"launches, not 2")
    for i, (g, w) in enumerate(zip(got, ring_exchange_cols_plain(many, n))):
        _require(torch.equal(g, w), f"65-column call differs from plain at {i}")

    batch_cols = [b for k, b in bufs.items() if k != "double"]
    nbytes = sum(b.numel() * b.element_size() for b in batch_cols)
    Q = batch_cols[0].shape[1] // n
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)

    def kernel():
        return ring_exchange_cols(batch_cols, n)

    def plain():
        return [ring_exchange_plain(b, n) for b in batch_cols]

    def library():
        # one PyTorch call of the same function per column (timed only; the
        # port never calls it)
        return [b.view(n, n, Q).transpose(0, 1).contiguous() for b in batch_cols]

    out = {}
    for name, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        out[name] = time_ms(fn, flush=scratch)
    for name, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        out[name + "_warm_l2"] = time_ms(fn)
    out["host_ms"] = host_ms(kernel)
    out["device_ms"], out["device_seen"] = device_ms(
        kernel, "ring_exchange_cols_kernel", scratch)
    out["bound_ms"] = 2 * nbytes / H100_BYTES_PER_S * 1e3   # read once + write once
    out["roofline_share"] = out["bound_ms"] / out["device_ms"]
    out.update(max_abs_err=max_err, bytes_each_way=nbytes,
               columns=len(batch_cols), buffers=len(every))
    return out


# -------------------------------------------------------------- distinct

class ScanRecorder:
    """Stands in for ``distinct_scan`` where the aggregators call it: every
    call goes through to the wrapper (which launches the kernel and
    counts), and the arguments of call ``at`` are kept, the state cloned
    before the call updates it in place, for the kernel's checks and
    timings at the main path's shapes."""

    def __init__(self, at: int):
        self.at, self.calls, self.args, self.kwargs = at, 0, None, None

    def __call__(self, *args, **kwargs):
        from siddhi_tpu_torch.ops.distinct import distinct_scan

        if self.calls == self.at:
            self.args = [a.clone() if a is not None else None for a in args]
            self.kwargs = dict(kwargs)
        self.calls += 1
        return distinct_scan(*args, **kwargs)


@contextlib.contextmanager
def recording(at: int):
    from siddhi_tpu_torch.ops import aggregators

    rec = ScanRecorder(at)
    orig = aggregators.distinct_scan
    aggregators.distinct_scan = rec
    try:
        yield rec
    finally:
        aggregators.distinct_scan = orig


def run_app(device, app: str, feed, streams=("OutStream",), key_slots=KEY_SLOTS,
            capacity=None, on_start=None):
    """Drive an app's ``bench`` query (and any others) through the public
    API; ``capacity`` sets the distinct value slots before the first send.
    Returns ({stream: per-batch output columns}, per-batch seconds, facts)."""
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device=device)
    rt = m.create_siddhi_app_runtime(app)
    q = rt.query_runtimes["bench"]
    if key_slots is not None:
        q.selector_plan.num_keys = key_slots
    if capacity is not None:
        for spec in q.selector_plan.specs:
            spec.distinct_capacity = capacity
    cbs = {name: collector() for name in streams}
    for name, cb in cbs.items():
        rt.add_callback(name, cb)
    if on_start is not None:
        on_start()
    seconds = send_timed(rt.get_input_handler("StockStream"), feed, device)
    facts = {"stage": type(q.window_stage).__name__,
             "state_bytes": sum(t.numel() * t.element_size()
                                for r in rt.query_runtimes.values()
                                if r._state is not None for t in _leaves(r._state))}
    m.shutdown()
    return {n: cb.batches for n, cb in cbs.items()}, seconds, facts


def scan_facts(args, kwargs):
    """Byte bound and longest chain of one distinct-scan call: each touched
    group's table read and written once, every row input read once, the
    counts (and unionSet snapshots) written once."""
    import torch

    vk = args[0]
    g = args[3]
    K, H = vk.shape
    R = g.numel()
    counts = torch.bincount(g, minlength=K)
    touched = int((counts > 0).sum())
    table = touched * (H * (8 + 4) + 8)
    rows_in = sum(t.numel() * t.element_size() for t in args[3:] if t is not None)
    out = R * 8 + (R * H * 9 if kwargs.get("emit_set") else 0)
    nbytes = 2 * table + rows_in + out
    return {"rows": R, "groups": touched, "H": H, "chain": int(counts.max()),
            "bytes": nbytes, "bound_ms": nbytes / H100_BYTES_PER_S * 1e3}


def check_scan(args, kwargs, what: str, cut=None):
    """Kernel against the plain version on the same inputs (on the first
    ``cut`` rows when given): counts, snapshots, overflow and the updated
    state exactly equal."""
    import torch

    from siddhi_tpu_torch.ops.distinct import distinct_scan, distinct_scan_plain

    rows = [a if a is None or cut is None else a[:cut] for a in args[3:]]
    st_k = [t.clone() for t in args[:3]]
    st_p = [t.clone() for t in args[:3]]
    got = distinct_scan(*st_k, *rows, **kwargs)
    torch.cuda.synchronize()
    want = distinct_scan_plain(*st_p, *rows, **kwargs)
    for name, a, b in zip(("counts", "snapshot keys", "snapshot mask", "overflow"),
                          got, want):
        _require((a is None) == (b is None), f"{what}: kernel and plain disagree "
                 f"on whether there are {name}")
        if a is not None:
            _require(torch.equal(a, b), f"{what}: kernel {name} differ from plain")
    for name, a, b in zip(("vk", "vc", "stamp"), st_k, st_p):
        _require(torch.equal(a, b), f"{what}: kernel state {name} differs from plain")
    return float((got[0] - want[0]).abs().max()) if got[0].numel() else 0.0


def time_scan(args, kwargs, flush, runs=TIMED_RUNS, plain_runs=TIMED_RUNS,
              plain_cut=None):
    """CUDA-event ms of the kernel and of the plain version (L2 flushed),
    host enqueue ms and device ms of the kernel, each over ``runs`` calls
    (``plain_runs`` for the plain version, on the first ``plain_cut``
    rows when given). Every call gets a fresh copy of the pre-call state
    (the scan updates it in place). Device ms is the whole launch: the
    offsets kernel and the scan."""
    from siddhi_tpu_torch.ops.distinct import distinct_scan, distinct_scan_plain

    state, rows = args[:3], args[3:]

    def calls(fn, n, cut=None):
        pool = [[t.clone() for t in state] for _ in range(n + 1)]
        r = [a if a is None or cut is None else a[:cut] for a in rows]
        return lambda: fn(*pool.pop(), *r, **kwargs)

    out = {"ms": time_ms(calls(distinct_scan, runs), runs=runs, flush=flush),
           "plain_ms": time_ms(calls(distinct_scan_plain, plain_runs, plain_cut),
                               runs=plain_runs, flush=flush),
           "host_ms": host_ms(calls(distinct_scan, runs), runs=runs)}
    out["device_ms"], out["device_seen"] = device_ms(
        calls(distinct_scan, runs), "distinct_scan_", flush, runs=runs,
        main=("distinct_scan_registers", "distinct_scan_hash"))
    out["runs"] = runs
    if plain_cut is not None:
        out["cut_ms"] = time_ms(calls(distinct_scan, plain_runs, plain_cut),
                                runs=plain_runs, flush=flush)
    return out


def check_oracle(args, kwargs, what: str):
    """The kernel over one whole recorded batch against ``scan_oracle`` on
    the host: counts, snapshots, overflow and the updated state exactly
    equal. Returns the oracle's host seconds."""
    import numpy as np
    import torch

    from siddhi_tpu_torch.ops.distinct import distinct_scan

    st = [t.clone() for t in args[:3]]
    host = [t.cpu().numpy().copy() for t in args[:3]]
    rows = [None if a is None else a.cpu().numpy() for a in args[3:]]
    got = distinct_scan(*st, *args[3:], **kwargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = scan_oracle(*host, *rows, **kwargs)
    seconds = time.perf_counter() - t0
    for name, a, b in zip(("counts", "snapshot keys", "snapshot mask"), got, want):
        _require((a is None) == (b is None), f"{what}: kernel and oracle disagree "
                 f"on whether there are {name}")
        if a is not None:
            _require(np.array_equal(a.cpu().numpy(), b),
                     f"{what}: kernel {name} differ from the host oracle")
    _require(bool(got[3]) == want[3], f"{what}: kernel overflow {bool(got[3])}, "
             f"oracle {want[3]}")
    for name, a, b in zip(("vk", "vc", "stamp"), st, host):
        _require(np.array_equal(a.cpu().numpy(), b),
                 f"{what}: kernel state {name} differs from the host oracle")
    return seconds


def crossover(args, kwargs, flush):
    """D1's recorded rows over tables of each H in ``CROSSOVER_H`` (the
    carried table cut or padded with never-used slots), through each of
    the kernel's paths: the launch's device ms (torch.profiler, L2
    flushed; a whole call is host-bound here, so CUDA events would time
    the host), and every path's counts and state equal to the first's."""
    import torch

    from siddhi_tpu_torch.ops import distinct

    vk, vc, stamp = args[:3]
    rows = args[3:]
    emit = kwargs.get("emit_set", False)
    paths = {"registers": distinct.PATH_REGISTERS, "hash": distinct.PATH_HASH}
    out = {}
    for H in CROSSOVER_H:
        k = min(H, vk.shape[1])
        vk_h = torch.zeros((vk.shape[0], H), dtype=vk.dtype, device=vk.device)
        vc_h = torch.full((vc.shape[0], H), -1, dtype=vc.dtype, device=vc.device)
        vk_h[:, :k], vc_h[:, :k] = vk[:, :k], vc[:, :k]
        ref = None
        for name, path in paths.items():
            st = [vk_h.clone(), vc_h.clone(), stamp.clone()]
            got = distinct.launch(*st, *rows, emit, path)
            torch.cuda.synchronize()
            if ref is None:
                ref = (got, st)
            else:
                _require(torch.equal(got[0], ref[0][0]) and all(
                    torch.equal(a, b) for a, b in zip(st, ref[1])),
                    f"crossover H={H}: the hash path differs from registers")
            pool = [[vk_h.clone(), vc_h.clone(), stamp.clone()]
                    for _ in range(CROSSOVER_RUNS + 1)]
            out[(H, name)], _seen = device_ms(
                lambda: distinct.launch(*pool.pop(), *rows, emit, path),
                "distinct_scan_", flush, runs=CROSSOVER_RUNS,
                main=("distinct_scan_registers", "distinct_scan_hash"))
    return out


def sliding_distinct(symbols, window: int):
    """Distinct symbols among the trailing ``window`` events after each
    event, counted with a plain Python multiset (the independent check)."""
    import numpy as np

    _u, ids = np.unique(symbols, return_inverse=True)
    ids = ids.tolist()
    count = [0] * (max(ids) + 1)
    live, out = 0, []
    for t, s in enumerate(ids):
        if count[s] == 0:
            live += 1
        count[s] += 1
        if t >= window:
            o = ids[t - window]
            count[o] -= 1
            if count[o] == 0:
                live -= 1
        out.append(live)
    return np.asarray(out, np.int64)


def scan_oracle(vk, vc, stamp, g, v, delta, part, ep, set_in=None,
                set_in_m=None, emit_set=False):
    """The distinct scan as a sequential host model, independent of the
    port: row by row in arrival order, each touched group keeps a dict
    from value to a heap of its live slots (a carried-in table may hold a
    value live in more than one slot; the lowest wins) and a heap of its
    free slots (count <= 0), under the rules of ops/distinct.py: a row
    whose epoch differs from the group's stamp reads the table as empty
    and writes the reset only when it applies; an EXPIRED value with no
    live slot writes its key into the lowest free slot with count 0; a
    participating row that finds no slot overflows. numpy in, ``vk``,
    ``vc`` and ``stamp`` updated in place; returns ``(nd, snap_vk,
    snap_live, overflow)`` (the snapshots None unless ``emit_set``)."""
    import heapq

    import numpy as np

    K, H = vk.shape
    R = len(g)
    nd = np.zeros(R, np.int64)
    snap_vk = np.zeros((R, H), np.int64) if emit_set else None
    snap_live = np.zeros((R, H), bool) if emit_set else None
    overflow = False
    tables = {}                 # group -> [value -> live slots, free slots, live]
    gl, dl, pl, el = g.tolist(), delta.tolist(), part.tolist(), ep.tolist()
    if set_in is None:
        rows = ([(x, p)] for x, p in zip(v.tolist(), pl))
    else:
        rows = ([(x, p and m) for x, m in zip(xs, ms)]
                for xs, ms, p in zip(set_in.tolist(), set_in_m.tolist(), pl))
    for i, elems in enumerate(rows):
        gi = gl[i]
        t = tables.get(gi)
        if t is None:
            live = {}
            for s in np.flatnonzero(vc[gi] > 0).tolist():
                heapq.heappush(live.setdefault(int(vk[gi, s]), []), s)
            t = tables[gi] = [live, np.flatnonzero(vc[gi] <= 0).tolist(),
                              int((vc[gi] > 0).sum())]
        fresh = int(stamp[gi]) != el[i]
        applied = False
        for val, p in elems:
            live, free = t[0], t[1]
            slots = None if fresh else live.get(val)
            slot = slots[0] if slots else 0 if fresh else free[0] if free else None
            if slot is None:
                overflow |= bool(p)
                continue
            if not p:
                continue
            if fresh:               # the reset, written by the first applied element
                vc[gi] = -1
                t[:] = [{}, list(range(H)), 0]
                live, free, fresh = t[0], t[1], False
            newc = max((int(vc[gi, slot]) if slots else 0) + dl[i], 0)
            vk[gi, slot] = val
            vc[gi, slot] = newc
            if not slots and newc > 0:      # born: the lowest free slot
                heapq.heappop(free)
                live[val] = [slot]
                t[2] += 1
            elif slots and newc == 0:       # died: the slot is free again
                heapq.heappop(slots)
                if not slots:
                    del live[val]
                heapq.heappush(free, slot)
                t[2] -= 1
            applied = True
        if applied:
            stamp[gi] = el[i]
        nd[i] = 0 if fresh else t[2]
        if emit_set:
            snap_vk[i] = vk[gi]
            snap_live[i] = False if fresh else vc[gi] > 0
    return nd, snap_vk, snap_live, overflow


def one_group(device, feed, label: str, window: int, H: int, flush, card: str,
              on_start, app: str = D2_APP, column: str = "symbol",
              runs: int = TIMED_RUNS):
    """``distinctCount(<column>)`` over a ``#window.length(window)`` with no
    ``group by`` (one chain of every row) at ``H`` value slots: one launch
    per batch, every count equal to ``sliding_distinct``'s; the kernel on
    batch 3 == plain on its first ``D2_CUT`` rows and == ``scan_oracle``
    on the whole batch; its timings over ``runs`` calls. Returns (kernel
    facts with the app's state bytes and events/s, launches, max abs
    error)."""
    import numpy as np

    from siddhi_tpu_torch.ops.distinct import distinct_scan

    n = len(feed)
    with recording(at=2) as rec:
        out, secs, facts = run_app(device, app.format(W=window), feed,
                                   key_slots=None, capacity=H, on_start=on_start)
    launches = distinct_scan.launches
    _require(launches == n, f"{label}: {launches} launches for {n} batches")
    got = np.concatenate([b["distinct"] for b in out["OutStream"]])
    want = sliding_distinct(np.concatenate([c[column] for c, _t in feed]), window)
    _require(got.shape == want.shape and np.array_equal(got, want),
             f"{label}: distinct symbols differ from the numpy count at "
             f"{np.nonzero(got != want)[0][:5].tolist() if got.shape == want.shape else 'shape'}")
    a, kw = rec.args, rec.kwargs
    err = check_scan(a, kw, f"{label} scan", cut=D2_CUT)
    oracle_s = check_oracle(a, kw, f"{label} scan")
    k = {**scan_facts(a, kw),
         **time_scan(a, kw, flush, runs=runs, plain_runs=1, plain_cut=D2_CUT)}
    k["share"] = k["bound_ms"] / k["device_ms"]
    k["ns_per_row"] = k["device_ms"] * 1e6 / k["chain"]
    k["state_bytes"], k["eps"] = facts["state_bytes"], steady_eps(secs, BATCH)
    print(f"[distinct] {label} distinctCount({column}) over #window.length({window}), "
          f"one group, H={H}: {facts['state_bytes']} state bytes, {launches} "
          f"launches, no overflow, every count == numpy's over {len(got)} rows, "
          f"peak {int(got.max())}; first batch {secs[0] * 1e3:.1f} ms, then "
          f"{steady_eps(secs, BATCH):.1f} events/s [{card}]", flush=True)
    print(f"[distinct] kernel at {label}'s shape (batch 3: {k['rows']} rows, one "
          f"chain of {k['chain']}): == plain on the first {D2_CUT} rows (kernel "
          f"{k['cut_ms']:.4f} ms, plain {k['plain_ms']:.4f} ms there); == the host "
          f"oracle on the whole batch (state, counts; oracle {oracle_s:.2f} s); "
          f"whole batch, L2 flushed: kernel {k['ms']:.4f} ms; host enqueue "
          f"{k['host_ms']:.4f} ms; device {k['device_ms']:.4f} ms "
          f"({k['device_seen']} of {k['runs']} launches seen), "
          f"{k['ns_per_row']:.1f} ns per chain row, against a {k['bound_ms']:.4f} "
          f"ms byte bound, share {k['share']:.6f} [{card}]", flush=True)
    return k, launches, err


def phase_distinct(device, feed, card: str):
    """D1, D2, D3 and S on the card (see the module doc). Returns the
    distinct kernel's measurements at D1's, D2's and D3's shapes and its
    launch count on each main-path run."""
    import numpy as np
    import torch

    from siddhi_tpu_torch.ops.distinct import distinct_scan

    def reset():
        distinct_scan.launches = 0

    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    d1_app, n = D1_APP.format(W=WINDOW), len(feed)

    # D1: the flagship's shape, grouped, on the generic path
    with recording(at=n - 1) as rec1:
        d1, d1_s, f1 = run_app(device, d1_app, feed, on_start=reset)
    d1_launches = distinct_scan.launches
    _require(f1["stage"] == "LengthWindowStage",
             f"D1 planned on {f1['stage']}, not the generic window")
    _require(d1_launches == n, f"D1: {d1_launches} distinct-scan launches for "
             f"{n} batches: want one per batch")
    d1 = d1["OutStream"]
    rows_out = sum(len(b["__ts__"]) for b in d1)
    _require(rows_out == n * BATCH, f"D1: {rows_out} rows out for {n * BATCH} in")
    require_finite(d1, "D1 (card)")
    cpu, _s, _f = run_app(torch.device("cpu"), d1_app, feed[:CPU_BATCHES])
    worst = compare_outputs(d1[:CPU_BATCHES], cpu["OutStream"], "D1 card vs cpu")
    print(f"[distinct] D1 distinctCount(volume) + functions group by symbol, "
          f"H=64, {KEY_SLOTS} key slots: {f1['state_bytes']} state bytes on the "
          f"card, {d1_launches} kernel launches for {n} batches, no overflow, "
          f"{rows_out} rows out, first batch {d1_s[0] * 1e3:.1f} ms, then "
          f"{steady_eps(d1_s, BATCH):.1f} events/s [{card}]; first {CPU_BATCHES} "
          f"batches equal the CPU run (max float rel err {worst:.3g})", flush=True)

    a1, kw1 = rec1.args, rec1.kwargs
    err1 = check_scan(a1, kw1, "D1 scan")
    k1 = {**scan_facts(a1, kw1), **time_scan(a1, kw1, scratch)}
    k1["share"] = k1["bound_ms"] / k1["device_ms"]
    k1["ns_per_row"] = k1["device_ms"] * 1e6 / k1["chain"]
    print(f"[distinct] kernel at D1's shape (batch {n}: {k1['rows']} rows, "
          f"{k1['groups']} groups, H={k1['H']}, longest chain {k1['chain']}): "
          f"== plain; L2 flushed: kernel {k1['ms']:.4f} ms, plain "
          f"{k1['plain_ms']:.4f} ms; host enqueue {k1['host_ms']:.4f} ms; "
          f"device {k1['device_ms']:.4f} ms ({k1['device_seen']} of "
          f"{k1['runs']} launches seen), {k1['ns_per_row']:.1f} ns per chain "
          f"row, against a {k1['bound_ms']:.4f} ms byte bound ({k1['bytes']} "
          f"bytes), share {k1['share']:.4f} [{card}]", flush=True)
    cross = crossover(a1, kw1, scratch)
    for H in CROSSOVER_H:
        paths = " ".join(f"{name} {ms:.4f}" for (h, name), ms in cross.items()
                         if h == H)
        print(f"[distinct] crossover, D1's rows at H={H}, device ms of the "
              f"launch (L2 flushed, {CROSSOVER_RUNS} runs), every path == registers: "
              f"{paths} [{card}]", flush=True)

    # D2: one group, H = 1,024: distinct symbols among the last 1,000 trades
    k2, d2_launches, err2 = one_group(device, feed, "D2", WINDOW, D2_H, scratch,
                                      card, reset)
    # D3: one group, H = 8,192: distinct symbols among the last 10,000 trades
    k3, d3_launches, err3 = one_group(device, feed, "D3", D3_WINDOW, D3_H, scratch,
                                      card, reset)

    # S: createSet -> window unionSet group by symbol -> sizeOfSet
    s_feed = feed[:S_BATCHES]
    s_app = S_APP.format(W=WINDOW)
    sets, s_s, fs = run_app(device, s_app, s_feed, ("OutStream", "VolStream"),
                            on_start=reset)
    s_launches = distinct_scan.launches
    _require(s_launches == S_BATCHES,
             f"S: {s_launches} launches for {S_BATCHES} batches")
    for i, (sb, db) in enumerate(zip(sets["OutStream"], d1)):
        # the rows align (one out per in, in order); the two apps' string
        # ids differ (D1 encodes 'high' and 'low' first)
        _require(np.array_equal(sb["n"], db["volumes"]),
                 f"S: sizeOfSet differs from D1's distinctCount in batch {i}")
    cpu_s, _s, _f = run_app(torch.device("cpu"), s_app, s_feed[:1], ("VolStream",))
    compare_outputs(sets["VolStream"][:1], cpu_s["VolStream"],
                    "S unionSet companions card vs cpu")
    print(f"[distinct] S unionSet chain: {fs['state_bytes']} state bytes, "
          f"{s_launches} launches for {S_BATCHES} batches; sizeOfSet == D1's "
          f"distinctCount row for row; the first batch's [{2 * BATCH}, 64] "
          f"companions equal the CPU run's; first batch {s_s[0] * 1e3:.1f} ms, "
          f"then {steady_eps(s_s, BATCH):.1f} events/s [{card}]", flush=True)

    m, rt, _q = global_runtime(device, d1_app, "bench")
    profile_sends("distinct D1", rt.get_input_handler("StockStream"), feed, card)
    m.shutdown()
    return {"launches": {"D1": d1_launches, "D2": d2_launches, "D3": d3_launches,
                         "S": s_launches},
            "d1": k1, "d2": k2, "d3": k3, "max_abs_err": max(err1, err2, err3),
            "d1_out": d1}


# -------------------------------------------------------------- pipeline

PIPE_DEPTHS = (1, 4, 8)
PIPE_TIMEOUT_S = 300


def wait_rows(cb, rows: int, what: str):
    """Wait, blocked on an event the collector sets (no polling thread
    competing for the GIL), until it holds ``rows`` output rows (an @Async
    worker delivers them); fails after PIPE_TIMEOUT_S."""
    cb.target = rows
    cb.reached.clear()
    if cb.rows >= rows:
        return
    _require(cb.reached.wait(PIPE_TIMEOUT_S),
             f"{what}: {cb.rows} of {rows} rows after {PIPE_TIMEOUT_S} s")


@contextlib.contextmanager
def counting_syncs(out: dict):
    """Count the card's host syncs in the block: torch's sync debug mode
    warns at each synchronizing call on any thread (``.item()``,
    ``nonzero``, a copy to pageable memory, ...); the warnings are
    recorded, counted and grouped by the Python line that made them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    sites = {}
    for w in syncs:
        key = f"{Path(w.filename).name}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1
    out["syncs"] = len(syncs)
    out["sync_sites"] = sorted(sites.items(), key=lambda kv: -kv[1])[:6]


def run_async(device, app: str, query: str, feed, depth: int, *, cfg=None,
              key_slots=KEY_SLOTS, setup=None, measure: str = "time"):
    """Drive an @Async app at ``pipeline_depth`` ``depth`` through the
    public API: the first batch is sent and drained alone (its new
    strings and the card's first launches), then the others back to back,
    from the first send until every output row has arrived. ``measure``:
    "time" (the host clock only) or "profile" (the card's busy share from
    torch.profiler and host syncs counted in sync debug mode; both slow
    the host, so the timed pass runs without them). Returns (per-batch
    output columns, facts)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager(
        {"siddhi_tpu.pipeline_depth": str(depth), **(cfg or {})}))
    rt = m.create_siddhi_app_runtime(app)
    q = rt.query_runtimes[query]
    if key_slots is not None:
        q.selector_plan.num_keys = key_slots
    if setup is not None:
        setup(q)
    cb = collector()
    rt.add_callback("OutStream", cb)
    h = rt.get_input_handler("StockStream")
    h.send_columns(feed[0][0], timestamps=feed[0][1])
    wait_rows(cb, BATCH, f"{query} depth {depth} first batch")
    pump = rt.app_context.completion_pump
    pump.high_water = 0
    pulls0, metas0, stalls0 = pump.pulls, pump.metas, pump.stalls
    facts = {}
    sends = []
    with contextlib.ExitStack() as stack:
        if measure == "profile":
            prof = stack.enter_context(profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            stack.enter_context(counting_syncs(facts))
        t0 = time.perf_counter()
        for cols, ts in feed[1:]:
            sends.append(time.perf_counter())
            h.send_columns(cols, timestamps=ts)
        wait_rows(cb, BATCH * len(feed), f"{query} depth {depth}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(feed) - 1
    facts.update(
        wall_s=wall, eps=BATCH * n / wall, high_water=pump.high_water,
        pulls=pump.pulls - pulls0, metas=pump.metas - metas0,
        stalls=pump.stalls - stalls0, dispatches=n)
    if len(cb.arrivals) == len(feed):        # one output batch per input batch
        lat = [(a - s_) * 1e3 for a, s_ in zip(cb.arrivals[1:], sends)]
        facts["latency_ms"] = (statistics.median(lat), max(lat))
    if measure == "profile":
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
        facts["busy_share"] = dev_us / 1e6 / wall
    facts["strings"] = list(rt.app_context.string_dictionary._to_str)
    m.shutdown()
    return cb.batches, facts


def require_equal(a, b, what: str, exact_floats: bool = True) -> float:
    """Per-batch outputs equal: ints, strings, timestamps, types and row
    order exactly, floats bit for bit (``exact_floats``) or to the repo's
    rtol. Returns the largest float relative difference."""
    worst = compare_outputs(a, b, what)
    if exact_floats:
        _require(worst == 0.0, f"{what}: floats differ (max rel err {worst:.3g})")
    return worst


def phase_pipeline(device, feed, fused, card: str):
    """bench.py's bench_pipeline_curve app (@Async, the global flagship)
    at depths 1, 4 and 8: outputs equal across depths and to phase 5's
    synchronous run, the pump holding >= 2 batches in flight at depth > 1;
    events/s, per-batch latency, metas per pull, busy share and host
    syncs per dispatch at each depth."""
    app = PIPE_APP.format(W=WINDOW)
    out = {}
    for depth in PIPE_DEPTHS:
        got, t = run_async(device, app, "bench", feed, depth)
        _got, p = run_async(device, app, "bench", feed, depth, measure="profile")
        worst = require_equal(got, fused, f"pipeline depth {depth} vs phase 5",
                              exact_floats=False)
        require_equal(_got, got, f"pipeline depth {depth}: profiled vs timed pass",
                      exact_floats=False)
        if depth > 1:
            _require(t["high_water"] >= 2 and p["high_water"] >= 2,
                     f"pipeline depth {depth}: the pump held at most "
                     f"{max(t['high_water'], p['high_water'])} batch(es) in flight")
        out[depth] = {**t, "busy_share": p["busy_share"], "syncs": p["syncs"],
                      "sync_sites": p["sync_sites"], "max_rel_err": worst}
        lat = t.get("latency_ms", (float("nan"), float("nan")))
        print(f"[pipeline] depth {depth}: {t['eps']:.1f} events/s send to drained "
              f"over {t['dispatches']} batches of {BATCH}; per-batch latency median "
              f"{lat[0]:.2f} ms, max {lat[1]:.2f} ms; most in flight {t['high_water']}; "
              f"{t['metas']} metas in {t['pulls']} pulls "
              f"({t['metas'] / max(1, t['pulls']):.2f} per pull), {t['stalls']} "
              f"stalled drains; card busy {100 * p['busy_share']:.1f}% of wall "
              f"(profiled pass, {p['eps']:.1f} events/s); host syncs "
              f"{p['syncs'] / p['dispatches']:.1f} per dispatch {p['sync_sites']}; "
              f"== phase 5 (max float rel err {worst:.3g}) [{card}]", flush=True)
    return out


def phase_pipeline_routed(device, feed, routed, card: str):
    """The routed partitioned flagship behind @Async at depth 4: one ring
    exchange launch per routed dispatch, no route overflow, output equal
    to phase 4's routed run."""
    from siddhi_tpu_torch.ops.exchange import ring_exchange
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    layout = {}

    def route(q):
        q._win_keys = KEY_SLOTS
        device_route_query_step(q, make_mesh(N_SHARDS, device),
                                rows_per_shard=ROWS_PER_SHARD)
        layout["rl"] = q._route_layout
        ring_exchange.launches = 0

    got, t = run_async(device, "@Async(buffer.size='64')\n" + APP.format(W=WINDOW),
                       "bench", feed, 4,
                       cfg={"siddhi_tpu.shard_exchange": "pallas_ring"}, setup=route)
    rl = layout["rl"]
    launches = ring_exchange.launches
    _require(launches == rl.dispatches >= len(feed),
             f"pipeline-routed: {launches} exchange launches for {rl.dispatches} "
             f"routed dispatches: want one per dispatch")
    _require(rl.route_overflow_rows == 0,
             f"pipeline-routed: route overflow {rl.route_overflow_rows}")
    _require(t["high_water"] >= 2,
             f"pipeline-routed: the pump held at most {t['high_water']} batch(es)")
    worst = require_equal(got, routed, "pipeline-routed vs phase 4", exact_floats=False)
    print(f"[pipeline-routed] x{N_SHARDS} at depth 4: {launches} exchange launches for "
          f"{rl.dispatches} routed dispatches, no route overflow, most in flight "
          f"{t['high_water']}, {t['eps']:.1f} events/s send to drained; == phase 4 "
          f"(max float rel err {worst:.3g}) [{card}]", flush=True)
    return launches


def phase_pipeline_distinct(device, feed, d1, card: str):
    """D1 behind @Async at depth 4: one distinct-scan launch per batch,
    output equal to phase 9's D1."""
    from siddhi_tpu_torch.ops.distinct import distinct_scan

    def reset(_q):
        distinct_scan.launches = 0

    got, t = run_async(device, "@Async(buffer.size='64')\n" + D1_APP.format(W=WINDOW),
                       "bench", feed, 4, setup=reset)
    launches = distinct_scan.launches
    _require(launches == len(feed),
             f"pipeline-distinct: {launches} launches for {len(feed)} batches")
    _require(t["high_water"] >= 2,
             f"pipeline-distinct: the pump held at most {t['high_water']} batch(es)")
    worst = require_equal(got, d1, "pipeline-distinct vs phase 9 D1", exact_floats=False)
    print(f"[pipeline-distinct] D1 at depth 4: {launches} distinct-scan launches for "
          f"{len(feed)} batches, most in flight {t['high_water']}, {t['eps']:.1f} "
          f"events/s send to drained; == phase 9's D1 (max float rel err "
          f"{worst:.3g}) [{card}]", flush=True)
    return launches


def phase_ingest(device, feed, fused, strings, card: str):
    """The feed as wire frames (WireEncoder -> decode_frame ->
    send_columns) and through a pool of 4 packers: the global flagship's
    output equal to phase 5's columns ingest, every dictionary id equal;
    host ms per 65,536-row decode and pack, inline and pooled."""
    import numpy as np

    from siddhi_tpu_torch import InMemoryConfigManager
    from siddhi_tpu_torch.core.event import HostBatch, StringDictionary
    from siddhi_tpu_torch.core.stream.input.pack_pool import IngestPackPool
    from siddhi_tpu_torch.core.stream.input.wire import (
        DecoderRegistry, WireEncoder, decode_frame)

    app = GLOBAL_APP.format(W=WINDOW)
    enc = WireEncoder(1)
    t0 = time.perf_counter()
    frames = [enc.encode(cols, timestamps=ts) for cols, ts in feed]
    encode_ms = (time.perf_counter() - t0) * 1e3 / len(feed)
    m, rt, _q = global_runtime(device, app, "bench")
    cb = collector()
    rt.add_callback("OutStream", cb)
    h = rt.get_input_handler("StockStream")
    reg, defn = DecoderRegistry(), rt.junctions["StockStream"].definition
    decode_ms = []
    for frame in frames:
        t0 = time.perf_counter()
        data, ts = decode_frame(frame, defn, rt.app_context.string_dictionary, reg)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        h.send_columns(data, timestamps=ts)
    wire_strings = list(rt.app_context.string_dictionary._to_str)
    m.shutdown()
    require_equal(cb.batches, fused, "wire ingest vs columns ingest", exact_floats=False)
    _require(wire_strings == strings, "wire ingest: dictionary ids differ from "
             "columns ingest")

    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device=device)
    split = max(256, BATCH // 8)     # 8,192 rows, the default, at the full size
    m.set_config_manager(InMemoryConfigManager({"siddhi_tpu.ingest_pool": "4",
                                                "siddhi_tpu.ingest_split": str(split)}))
    rt = m.create_siddhi_app_runtime(app)
    rt.query_runtimes["bench"].selector_plan.num_keys = KEY_SLOTS
    cb = collector()
    rt.add_callback("OutStream", cb)
    send_timed(rt.get_input_handler("StockStream"), feed, device)
    pool = rt.app_context.ingest_pack_pool
    _require(pool is not None and pool.subbatches >= 4 * len(feed),
             f"ingest pool: {getattr(pool, 'subbatches', 0)} sub-batches packed")
    pool_strings = list(rt.app_context.string_dictionary._to_str)
    m.shutdown()
    require_equal(cb.batches, fused, "pooled ingest vs inline", exact_floats=False)
    _require(pool_strings == strings, "pooled ingest: dictionary ids differ from inline")

    # the pack alone (HostBatch.from_columns, dictionary encode included),
    # inline and pooled, each into its own dictionary
    pool = IngestPackPool(rt.app_context, workers=4, split_rows=split)
    times = {"inline": [], "pool": []}
    dicts = {"inline": StringDictionary(), "pool": StringDictionary()}
    try:
        for cols, ts in feed:
            for name, pl in (("inline", None), ("pool", pool)):
                t0 = time.perf_counter()
                b = HostBatch.from_columns(cols, defn, dicts[name], timestamps=ts, pool=pl)
                times[name].append((time.perf_counter() - t0) * 1e3)
                if name == "inline":
                    ref = b
            for k in ref.cols:
                _require(np.array_equal(ref.cols[k], b.cols[k]),
                         f"pooled pack column {k} differs from inline")
    finally:
        pool.shutdown()
    _require(dicts["inline"]._to_str == dicts["pool"]._to_str,
             "pooled pack: dictionary ids differ")
    out = {"encode_ms": encode_ms, "decode_ms": statistics.mean(decode_ms[1:]),
           "decode_first_ms": decode_ms[0],
           "pack_ms": {k: statistics.mean(v[1:]) for k, v in times.items()},
           "pack_first_ms": {k: v[0] for k, v in times.items()}}
    print(f"[ingest] wire frames -> decode_frame -> send_columns == columns ingest, "
          f"every dictionary id equal; pool of 4 == inline (output and ids); host "
          f"ms per {BATCH}-row batch: encode {encode_ms:.2f}, decode "
          f"{out['decode_ms']:.2f} (first batch, {NUM_SYMBOLS} new strings: "
          f"{decode_ms[0]:.2f}); pack inline {out['pack_ms']['inline']:.2f}, pooled "
          f"{out['pack_ms']['pool']:.2f} (first batch {times['inline'][0]:.2f} / "
          f"{times['pool'][0]:.2f}) [{card}]", flush=True)
    return out


def phase_onerror(device, feed, card: str):
    """@OnError(action='stream'): a filter calls an extension function
    that raises when one symbol is present; that symbol is in one row of
    batch 2 only. The failing batch's rows arrive on !StockStream with
    _error, every other batch flows. A capacity overflow still raises
    FatalQueryError."""
    import numpy as np

    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.core.stream.junction import FatalQueryError
    from siddhi_tpu_torch.extension import ScalarFunction
    from siddhi_tpu_torch.query_api.definitions import AttrType

    bad = {}

    class Faults(StreamCallback):
        def __init__(self):
            self.events = []

        def receive(self, events):
            self.events.extend(events)

    class Tripwire(ScalarFunction):
        return_type = AttrType.BOOL

        @staticmethod
        def apply(xp, sym):
            if bool((sym == bad["id"]).any()):   # a host sync, by design
                raise ValueError("tripwire: symbol TRIP")
            return xp.ones_like(sym, dtype=xp.bool_)

    fail_at = 2
    feed = [(dict(cols), ts) for cols, ts in feed]
    sym = feed[fail_at][0]["symbol"].copy()
    sym[BATCH // 2] = "TRIP"
    feed[fail_at][0]["symbol"] = sym
    m = SiddhiManager(device=device)
    m.set_extension("function:tripwire", Tripwire)
    rt = m.create_siddhi_app_runtime("@OnError(action='stream')" + GLOBAL_APP.replace(
        "from StockStream#", "from StockStream[tripwire(symbol)]#").format(W=WINDOW))
    rt.query_runtimes["bench"].selector_plan.num_keys = KEY_SLOTS
    bad["id"] = rt.app_context.string_dictionary.encode("TRIP")
    cb, faults = collector(), Faults()
    rt.add_callback("OutStream", cb)
    rt.add_callback("!StockStream", faults)
    send_timed(rt.get_input_handler("StockStream"), feed, device)
    m.shutdown()
    fe = faults.events
    _require(len(fe) == BATCH,
             f"onerror: {len(fe)} fault rows, want the failing batch's {BATCH}")
    _require(np.array_equal(np.array([e.timestamp for e in fe]), feed[fail_at][1])
             and [e.data[0] for e in fe] == sym.tolist(),
             "onerror: the fault rows are not the failing batch's")
    _require(all("tripwire" in e.data[3] for e in fe),
             "onerror: _error does not name the failure")
    _require(cb.rows == BATCH * (len(feed) - 1) and len(cb.batches) == len(feed) - 1,
             f"onerror: {cb.rows} rows out of the other {len(feed) - 1} batches")

    over = SiddhiManager(device=device)
    rt = over.create_siddhi_app_runtime("@OnError(action='stream')" + D2_APP.format(W=WINDOW))
    for spec in rt.query_runtimes["bench"].selector_plan.specs:
        spec.distinct_capacity = 64
    try:
        rt.get_input_handler("StockStream").send_columns(feed[0][0], timestamps=feed[0][1])
        raised = None
    except FatalQueryError as e:
        raised = e
    finally:
        over.shutdown()
    _require(raised is not None and "distinct_values_capacity" in str(raised),
             "onerror: a full distinct value table did not raise FatalQueryError")
    print(f"[onerror] batch {fail_at}'s {BATCH} rows arrived on !StockStream with "
          f"_error, the other {len(feed) - 1} batches flowed ({cb.rows} rows); a "
          f"full value table still raised FatalQueryError [{card}]", flush=True)


def phase_transport(device, feed, card: str):
    """@source(type='inMemory') -> the global flagship -> @sink(type=
    'inMemory') over one batch of 65,536 rows, published one row a message
    (an @Async source stream coalesces them into units): what the sink
    publishes equals a StreamCallback's rows on the same stream."""
    import numpy as np

    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.extension import InMemoryBroker

    app = (GLOBAL_APP.format(W=WINDOW)
           .replace("define stream StockStream",
                    f"@Async(buffer.size='{BATCH}', batch.size='{BATCH}')\n"
                    "@source(type='inMemory', topic='smoke-in')\n"
                    "define stream StockStream")
           .replace("insert into OutStream;",
                    "insert into OutStream;\n@sink(type='inMemory', topic='smoke-out')\n"
                    "define stream OutStream (symbol string, avgPrice double, "
                    "totalVolume long);"))
    m = SiddhiManager(device=device)
    rt = m.create_siddhi_app_runtime(app)
    rt.query_runtimes["bench"].selector_plan.num_keys = KEY_SLOTS
    cb = collector()
    rt.add_callback("OutStream", cb)
    published = []

    class Sub(InMemoryBroker.Subscriber):
        topic = "smoke-out"

        def on_message(self, payload):
            published.append(payload)

    sub = Sub()
    InMemoryBroker.subscribe(sub)
    rt.start()
    cols, _ts = feed[0]
    rows = list(zip(cols["symbol"].tolist(), cols["price"].tolist(),
                    cols["volume"].tolist()))
    t0 = time.perf_counter()
    for row in rows:
        InMemoryBroker.publish("smoke-in", list(row))
    wait_rows(cb, BATCH, "transport")
    seconds = time.perf_counter() - t0
    m.shutdown()
    InMemoryBroker.unsubscribe(sub)
    dic = rt.app_context.string_dictionary
    want = [[dic.decode(int(i)), float(a), int(v)] for b in cb.batches
            for i, a, v in zip(b["symbol"], b["avgPrice"].tolist(),
                               b["totalVolume"].tolist())]
    _require(len(published) == BATCH and published == want,
             f"transport: the sink published {len(published)} rows, not the "
             f"{len(want)} the callback received")
    _require(np.isfinite(np.array([p[1] for p in published])).all(),
             "transport: non-finite averages")
    print(f"[transport] inMemory source -> flagship -> inMemory sink: {BATCH} rows in "
          f"{len(cb.batches)} units, the sink's payloads == the callback's rows, "
          f"{seconds:.2f} s from the first publish to the last row [{card}]", flush=True)


def phase_d4(device, feed, card: str):
    """D4: distinctCount(account) over #window.length(30000), one group,
    H = 32,768: the distinct scan's global-index path (one_group's
    checks). Returns (kernel facts with max_abs_err, launches)."""
    import torch

    from siddhi_tpu_torch.ops import distinct
    from siddhi_tpu_torch.ops.distinct import distinct_scan

    def reset():
        distinct_scan.launches = 0

    _require(distinct.kernel_path(D4_H) == distinct.PATH_WIDE, "D4: H does not take the global-index path")
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    k, launches, err = one_group(device, d4_feed(feed), "D4", D4_WINDOW, D4_H, scratch,
                                 card, reset, app=D4_APP, column="account", runs=D4_RUNS)
    k["max_abs_err"] = err
    return k, launches


def d4_feed(feed):
    """The feed with an ``account`` column: int64 ids drawn uniformly from
    100,000 by their own seeded generator (the other columns unchanged)."""
    import numpy as np

    rng = np.random.default_rng(44)
    return [({**cols, "account": rng.integers(0, D4_ACCOUNTS, BATCH, dtype=np.int64)}, ts)
            for cols, ts in feed]


# ------------------------------------------------------------------ main

def phase_global(device, feed, card: str):
    """The global flagship on the fused stage: the card against the CPU
    and against the generic path on the card."""
    import torch

    app = GLOBAL_APP.format(W=WINDOW)
    fused, fused_s, facts = run_global(device, app, "bench", feed)
    _require(facts["stage"] == "FusedSlidingAggStage",
             f"global flagship planned on {facts['stage']}, not the fused stage")
    _require(facts["precision"] == "exact" and facts["exact"] is True,
             f"global flagship precision {facts['precision']}, not exact")
    rows_out = sum(len(b["__ts__"]) for b in fused)
    _require(rows_out == len(feed) * BATCH,
             f"global: {rows_out} output rows for {len(feed) * BATCH} input rows")
    require_finite(fused, "global fused (card)")
    print(f"[global] fused stage, exact: {facts['state_bytes']} state bytes on "
          f"the card, {KEY_SLOTS} key slots, {rows_out} rows out, first batch "
          f"{fused_s[0] * 1e3:.1f} ms, then {steady_eps(fused_s, BATCH):.1f} "
          f"events/s [{card}]", flush=True)

    generic, generic_s, gfacts = run_global(device, app, "bench", feed, fused=False)
    _require(gfacts["stage"] == "LengthWindowStage",
             f"unfused global flagship planned on {gfacts['stage']}")
    worst = compare_outputs(fused, generic, "global fused vs generic (card)")
    print(f"[global] generic path (fusion off): {gfacts['state_bytes']} state "
          f"bytes, first batch {generic_s[0] * 1e3:.1f} ms, then "
          f"{steady_eps(generic_s, BATCH):.1f} events/s [{card}]; fused == "
          f"generic over {len(feed)} batches (max float rel err {worst:.3g})",
          flush=True)

    cpu_out, _s, _f = run_global(torch.device("cpu"), app, "bench",
                                 feed[:CPU_BATCHES])
    worst_cpu = compare_outputs(fused[:CPU_BATCHES], cpu_out,
                                "global card vs cpu (first batches)")
    print(f"[global] first {CPU_BATCHES} batches equal the port's CPU run "
          f"(max float rel err {worst_cpu:.3g})", flush=True)
    return fused, facts["strings"]


def phase_twin(device, feed, card: str):
    """The twin on the generic window -> aggregator path. Its feed is the
    bench feed with every price lowered by 15, so about 15% of the rows
    fail the twin's ``price > 0.0`` filter."""
    import numpy as np
    import torch

    feed = [({**cols, "price": cols["price"] - np.float32(15.0)}, ts)
            for cols, ts in feed]
    twin, twin_s, facts = run_global(device, TWIN_APP, "flagship", feed)
    _require(facts["stage"] == "LengthWindowStage",
             f"twin planned on {facts['stage']}, not the generic window")
    rows_out = sum(len(b["__ts__"]) for b in twin)
    positive = sum(int(np.count_nonzero(cols["price"] > 0)) for cols, _ts in feed)
    _require(rows_out == positive,
             f"twin: {rows_out} output rows for {positive} rows with price > 0")
    require_finite(twin, "twin (card)")
    cpu_out, _s, _f = run_global(torch.device("cpu"), TWIN_APP, "flagship",
                                 feed[:CPU_BATCHES])
    worst_cpu = compare_outputs(twin[:CPU_BATCHES], cpu_out,
                                "twin card vs cpu (first batches)")
    print(f"[twin] generic path: {facts['state_bytes']} state bytes, "
          f"{rows_out} rows out of {len(feed) * BATCH}, first batch "
          f"{twin_s[0] * 1e3:.1f} ms, then {steady_eps(twin_s, BATCH):.1f} "
          f"events/s [{card}]; first {CPU_BATCHES} batches equal the CPU run "
          f"(max float rel err {worst_cpu:.3g})", flush=True)


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "siddhi_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: siddhi_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import sysconfig

    from siddhi_tpu_torch import native
    from siddhi_tpu_torch.ops import _cuda
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| python {sys.version.split()[0]}", flush=True)
    device = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    built = _cuda.build(["ring_exchange", "distinct_scan"])
    print(f"[build] {len(built)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for name, (so, log) in built.items():
        print(f"[build] {name}: {so.name}")
        for line in log.strip().splitlines():
            print(f"[ptxas] {line}")
    t0 = time.perf_counter()
    so = native.build_strdict()
    print(f"[build] native string dictionary {so.name} in "
          f"{time.perf_counter() - t0:.1f} s (g++, CPython headers at "
          f"{sysconfig.get_paths()['include']})", flush=True)

    # 3. kernels at the flagship's shapes
    ex = check_exchange(device)
    print(f"[kernel] ring_exchange_cols exact on {ex['buffers']} buffers in one "
          f"call, on odd-byte segments, and on 65 columns in 2 launches; one "
          f"batch's {ex['columns']} columns, {ex['bytes_each_way']} bytes each "
          f"way, L2 flushed: kernel {ex['ms']:.4f} ms, plain {ex['plain_ms']:.4f} "
          f"ms, library {ex['library_ms']:.4f} ms; warm L2: kernel "
          f"{ex['ms_warm_l2']:.4f} ms, plain {ex['plain_ms_warm_l2']:.4f} ms, "
          f"library {ex['library_ms_warm_l2']:.4f} ms; host enqueue of one "
          f"call {ex['host_ms']:.4f} ms; kernel on the device "
          f"{ex['device_ms']:.4f} ms ({ex['device_seen']} of {TIMED_RUNS} launches "
          f"seen) against a {ex['bound_ms']:.4f} ms byte "
          f"bound (share {ex['roofline_share']:.3f}) [{card}]", flush=True)

    # 4. the slice
    feed = make_feed(5, N_BATCHES, BATCH, NUM_SYMBOLS)

    def reset_counts():
        ring_exchange.launches = 0
        ring_exchange.columns = 0

    routed, routed_s, facts = run_slice(device, feed, routed=True,
                                        on_route=reset_counts)
    launches, columns = ring_exchange.launches, ring_exchange.columns
    _require(launches > 0, "routed run launched no ring_exchange kernel")
    _require(launches == facts["dispatches"] >= N_BATCHES,
             f"{launches} exchange launches for {facts['dispatches']} routed "
             f"dispatches of {N_BATCHES} batches: want one per dispatch")
    _require(facts["route_overflow"] == 0,
             f"route overflow {facts['route_overflow']} on the routed run")
    rows_out = sum(len(b["__ts__"]) for b in routed)
    _require(rows_out == N_BATCHES * BATCH,
             f"{rows_out} output rows for {N_BATCHES * BATCH} input rows")
    print(f"[slice] routed x{N_SHARDS}: {facts['state_bytes']} state bytes on "
          f"the card, {facts['key_slots']} key slots, {facts['dispatches']} "
          f"dispatches, {launches} exchange launches of {columns} columns, "
          f"{rows_out} rows out, first batch "
          f"{routed_s[0] * 1e3:.1f} ms, then {steady_eps(routed_s, BATCH):.1f} "
          f"events/s [{card}]", flush=True)

    unrouted, unrouted_s, ufacts = run_slice(device, feed, routed=False)
    worst = compare_outputs(routed, unrouted, "routed vs unrouted (card)")
    print(f"[slice] unrouted: first batch {unrouted_s[0] * 1e3:.1f} ms, then "
          f"{steady_eps(unrouted_s, BATCH):.1f} events/s [{card}]; routed == "
          f"unrouted (max float rel err {worst:.3g})", flush=True)

    cpu_out, _cpu_s, _ = run_slice(torch.device("cpu"), feed[:CPU_BATCHES],
                                   routed=True)
    worst_cpu = compare_outputs(routed[:CPU_BATCHES], cpu_out,
                                "card vs cpu (first batches)")
    print(f"[slice] first {CPU_BATCHES} batches equal the port's CPU run "
          f"(max float rel err {worst_cpu:.3g})", flush=True)

    # 5. the global flagship, fused
    fused, strings = phase_global(device, feed, card)

    # 6. the twin, generic
    phase_twin(device, feed, card)

    # 7. the native string dictionary
    native_ms, plain_ms = check_strdict(feed)
    print(f"[strdict] native ids == plain ids over {len(feed)} batches of "
          f"{BATCH} symbols; host ms per encode, first batch ({NUM_SYMBOLS} "
          f"new strings): native {native_ms[0]:.2f}, plain {plain_ms[0]:.2f}; "
          f"later batches, mean: native "
          f"{statistics.mean(native_ms[1:]):.2f}, plain "
          f"{statistics.mean(plain_ms[1:]):.2f} [{card}]", flush=True)

    # 8. where the time goes
    profile_routed(device, feed, card)
    profile_global(device, feed, card)

    # 9. distinctCount / unionSet and the function library
    dist = phase_distinct(device, feed, card)
    d1 = dist["d1"]

    # 10. pipelined dispatch: the flagship behind @Async at depths 1, 4, 8
    pipe = phase_pipeline(device, feed, fused, card)
    # 11. the routed flagship behind @Async at depth 4
    routed_pipe_launches = phase_pipeline_routed(device, feed, routed, card)
    # 12. D1 behind @Async at depth 4
    dist["launches"]["D1_pipeline"] = phase_pipeline_distinct(
        device, feed, dist["d1_out"], card)
    # 13. the ingest front door: wire frames and the pack pool
    ingest = phase_ingest(device, feed, fused, strings, card)
    # 14. @OnError(action='stream')
    phase_onerror(device, feed, card)
    # 15. inMemory source -> flagship -> inMemory sink
    phase_transport(device, feed, card)
    # 16. D4: the distinct scan above H = 16,384
    d4, d4_launches = phase_d4(device, feed, card)

    # 17. result lines
    print(f"[time] whole script {time.perf_counter() - t_start:.1f} s", flush=True)
    kernels = [{
        "name": "ring_exchange", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/ring_exchange.cu",
        "replaces": "siddhi_tpu/parallel/mesh.py:1242",
        "launches": launches, "max_abs_err": ex["max_abs_err"],
        "ms": ex["ms"], "kernel_ms": ex["ms"], "plain_ms": ex["plain_ms"],
        "bound_ms": ex["bound_ms"], "bound_by": "bytes",
        "library_ms": ex["library_ms"], "device_ms": ex["device_ms"],
        "roofline_share": ex["roofline_share"],
        "columns_per_launch": columns / launches,
        "ms_warm_l2": ex["ms_warm_l2"],
        "plain_ms_warm_l2": ex["plain_ms_warm_l2"],
        "library_ms_warm_l2": ex["library_ms_warm_l2"],
        "host_ms": ex["host_ms"],
        "launches_pipeline_routed": routed_pipe_launches,
    }, {
        "name": "distinct_scan", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/distinct_scan.cu",
        "replaces": "siddhi_tpu/ops/aggregators.py:291",
        "launches": sum(dist["launches"].values()),
        "launches_by_run": dist["launches"], "max_abs_err": dist["max_abs_err"],
        "ms": d1["ms"], "plain_ms": d1["plain_ms"], "bound_ms": d1["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "device_ms": d1["device_ms"],
        "roofline_share": d1["share"], "host_ms": d1["host_ms"],
        "chain": d1["chain"], "rows": d1["rows"], "H": d1["H"],
        "ns_per_chain_row": d1["ns_per_row"],
        **{name: {k: dist[name][k] for k in (
            "ms", "device_ms", "bound_ms", "share", "host_ms", "chain", "H",
            "ns_per_row", "cut_ms", "plain_ms")} for name in ("d2", "d3")},
    }, {
        # the same kernel's global-index path (H > 16,384), at D4's shape:
        # ms and bound_ms over one whole batch, plain_ms and cut_ms (the
        # kernel) on its first D2_CUT rows
        "name": "distinct_scan (H > 16,384)", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/distinct_scan.cu",
        "replaces": "siddhi_tpu/ops/aggregators.py:291",
        "launches": d4_launches, "max_abs_err": d4["max_abs_err"],
        "ms": d4["ms"], "plain_ms": d4["plain_ms"], "bound_ms": d4["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "device_ms": d4["device_ms"],
        "roofline_share": d4["share"], "host_ms": d4["host_ms"],
        "chain": d4["chain"], "rows": d4["rows"], "H": d4["H"],
        "ns_per_chain_row": d4["ns_per_row"], "cut_ms": d4["cut_ms"],
        "plain_rows": D2_CUT, "state_bytes": d4["state_bytes"], "events_per_s": d4["eps"],
    }]
    print(json.dumps({"pipeline": {
        str(d): {k: v for k, v in f.items() if k != "strings"} for d, f in pipe.items()},
        "ingest": ingest}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
