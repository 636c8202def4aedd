"""The two plain references against per-event Python loops, and against
the port run on the CPU, at small sizes."""

import collections

import numpy as np
import pytest

from portbench import harness
from portbench.generator import Traffic
from portbench.reference import stock_distinct_l10000 as distinct_ref
from portbench.reference import stock_part_l1000_r4 as part_ref


def part_loop(stream_ids, price, volume, window):
    """Per symbol, a deque of its last ``window`` rows: the count, the f64
    mean of price and the sum of volume after each row."""
    rows = collections.defaultdict(collections.deque)
    avg, vol = [], []
    for s, p, v in zip(stream_ids.tolist(), price.tolist(), volume.tolist()):
        d = rows[s]
        d.append((p, v))
        if len(d) > window:
            d.popleft()
        avg.append(sum(x for x, _ in d) / len(d))
        vol.append(sum(y for _, y in d))
    return np.array(avg), np.array(vol, np.int64)


def distinct_loop(stream_ids, window):
    """A multiset of the last ``window`` rows: its distinct values after
    each row."""
    count = collections.Counter()
    ids, out = stream_ids.tolist(), []
    for t, s in enumerate(ids):
        count[s] += 1
        if t >= window:
            o = ids[t - window]
            count[o] -= 1
            if count[o] == 0:
                del count[o]
        out.append(len(count))
    return np.array(out, np.int64)


def small(config, keys, window, dist=None):
    config = dict(config, window=window, keys=dict(config["keys"], count=keys))
    mix = {"batch": 64, "pool_batches": 3, "streams": {"StockStream": {
        "symbol": dist or {"dist": "keys_uniform"},
        "price": {"dist": "uniform", "low": 0.0, "high": 100.0},
        "volume": {"dist": "uniform_int", "low": 1, "high": 1000}}}}
    return config, mix


@pytest.mark.parametrize("keys,window,dist", [
    (5, 4, None), (20, 30, None), (40, 8, {"dist": "keys_zipf", "exponent": 1.2})])
def test_part_reference_equals_the_loop(tiny_spec, keys, window, dist):
    config, mix = small(tiny_spec.config("stock_part_l1000_r4"), keys, window, dist)
    traffic = Traffic(config, mix, 7)
    n = 9
    raw = traffic.raw_range(0, n)
    avg, vol = part_loop(raw["symbol"], raw["price"].astype(np.float64),
                         raw["volume"], window)
    want = part_ref.expected(traffic, range(n), config)
    for g in range(n):
        s = slice(g * 64, (g + 1) * 64)
        np.testing.assert_array_equal(want[g]["volume"], vol[s])
        np.testing.assert_allclose(want[g]["avg"], avg[s], rtol=1e-12)
        np.testing.assert_array_equal(want[g]["ts"], np.arange(g * 64, (g + 1) * 64))


@pytest.mark.parametrize("keys,window", [(5, 4), (30, 50), (200, 100), (100, 150)])
def test_distinct_reference_equals_the_loop(tiny_spec, keys, window):
    config, mix = small(tiny_spec.config("stock_distinct_l10000"), keys, window)
    traffic = Traffic(config, mix, 11)
    n = 8
    want = distinct_loop(traffic.raw_range(0, n)["symbol"], window)
    got = distinct_ref.expected(traffic, range(n), config)
    for g in range(n):
        np.testing.assert_array_equal(got[g]["distinct"], want[g * 64:(g + 1) * 64])


@pytest.mark.parametrize("workload", ["part.uniform", "distinct.uniform"])
def test_port_on_the_cpu_equals_the_reference(tiny_spec, cpu, workload):
    run = harness.run_cell(tiny_spec, workload, 2**31 + 5, 0.5, False, cpu, 0.0)
    checks = harness.judge(tiny_spec, run)
    assert run.attempted > 0 and run.failed == 0
    assert len(run.outputs) >= 2
    assert harness.passed(checks), checks


@pytest.mark.parametrize("workload,number", [
    ("part.uniform", "avg_err"), ("distinct.uniform", "distinct_mismatch")])
def test_control_is_not_correct(tiny_spec, workload, number):
    """The reference one precision lower in the program's place (float32
    sums; a direct-mapped value table) fails the check, on three seeds."""
    cell = tiny_spec.cell(workload)
    config = tiny_spec.config(cell["config"])
    ref = tiny_spec.reference(config["name"])
    for seed in (1, 2, 3):
        traffic = Traffic(config, tiny_spec.mix(cell["traffic"]), seed)
        batches = [config["fill_batches"] + 3, config["fill_batches"] + 9]
        want = ref.expected(traffic, batches, config)
        got = ref.compare(want, ref.control(traffic, batches, config))
        assert got[number] > ref.LIMITS[number], (seed, got)
        assert ref.compare(want, {g: _as_outputs(w) for g, w in want.items()})[number] == 0


def _as_outputs(w):
    """The reference's expected values under the program's column names."""
    if "avg" in w:
        return {"__ts__": w["ts"], "symbol": w["key"], "avgPrice": w["avg"],
                "totalVolume": w["volume"]}
    return {"__ts__": w["ts"], "distinct": w["distinct"]}
