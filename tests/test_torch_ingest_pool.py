"""The port's ingest pack pool (``core/stream/input/pack_pool.py``), held
against the reference (tests/test_ingest_pool.py): pooled packs are
bit-identical to inline ones, rows and dictionary id order alike, on the
Event and the columns path; a sub-batch completing late still merges in
order; a killed packer's sub-batch is re-packed, never lost, and the
worker respawns; small batches stay inline; junk knob spellings raise.
The inline run of the port is also held against the reference's."""

import time

import numpy as np
import pytest
from torch_helpers import assert_rows_match, make_collector

import siddhi_tpu
import siddhi_tpu_torch
from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException
from siddhi_tpu_torch.core.event import Event

APP = """
define stream S (sym string, v double, n long);
@info(name='q') from S#window.length(64)
  select sym, sum(v) as sv, count() as c group by sym
  insert into Out;
"""


def _manager(pool, split=128, pkg="torch"):
    cfg = {"siddhi_tpu.ingest_pool": str(pool), "siddhi_tpu.ingest_split": str(split)}
    if pkg == "jax":
        from siddhi_tpu.core.util.config import InMemoryConfigManager

        m = siddhi_tpu.SiddhiManager()
        m.set_config_manager(InMemoryConfigManager(cfg))
        return m
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    m.set_config_manager(siddhi_tpu_torch.InMemoryConfigManager(cfg))
    return m


def _batches(event_cls, n_batches=5, rows=700, seed=3):
    rng = np.random.default_rng(seed)
    out, ts = [], 0
    for b in range(n_batches):
        keys = rng.integers(0, 15 + 25 * b, rows)   # new strings per batch
        evs = []
        for i in range(rows):
            sym = None if i % 97 == 5 else f"K{keys[i]}"
            evs.append(event_cls(timestamp=ts, data=[
                sym, float(np.round(rng.random() * 10, 6)), int(i)]))
            ts += 1
        out.append(evs)
    return out


def _run(pool, arm=None, pkg="torch"):
    m = _manager(pool, pkg=pkg)
    rt = m.create_siddhi_app_runtime(APP)
    c = make_collector((siddhi_tpu if pkg == "jax" else siddhi_tpu_torch).StreamCallback)
    rt.add_callback("Out", c)
    rt.start()
    pl = rt.app_context.ingest_pack_pool
    if arm is not None:
        arm(pl)
    h = rt.get_input_handler("S")
    event_cls = siddhi_tpu.core.event.Event if pkg == "jax" else Event
    for evs in _batches(event_cls):
        h.send(evs)
    strings = list(rt.app_context.string_dictionary._to_str)
    stats = None if pl is None else {
        "subbatches": pl.subbatches, "repacks": pl.repacked_subbatches,
        "deaths": pl.worker_deaths, "alive": pl.alive_workers()}
    m.shutdown()
    return c.rows, strings, stats


_REF = {}


def _inline():
    if "rows" not in _REF:
        _REF["rows"], _REF["strings"], _ = _run(0)
    return _REF["rows"], _REF["strings"]


def test_inline_run_equals_the_reference():
    rows, strings = _inline()
    ref_rows, ref_strings, _ = _run(0, pkg="jax")
    assert strings == ref_strings
    # sums of 64 values in [0, 10] may cancel to near zero, where the two
    # packages' summation orders differ by up to 64 * 640 * eps (F1)
    assert_rows_match(rows, ref_rows, atol=1e-11)


@pytest.mark.parametrize("arm", ["none", "late_subbatch"])
def test_pool_bit_identity_and_dictionary_order(arm):
    """Pool of 2, with every sub-batch on time or one sub-batch delayed
    (out-of-order completion): rows and id assignment order identical
    to the inline pack."""
    def delay_once(pool):
        def hook(p):
            p.fault_hook = None
            time.sleep(0.1)

        pool.fault_hook = hook

    rows, strings, stats = _run(2, arm=delay_once if arm == "late_subbatch" else None)
    ref_rows, ref_strings = _inline()
    assert rows == ref_rows and len(rows) > 0
    assert strings == ref_strings
    assert stats["subbatches"] > 0


def test_kill_packer_subbatch_repacked_not_lost():
    def kill_once(pool):
        def hook(p):
            p.fault_hook = None
            raise RuntimeError("injected kill on ingest pack worker")

        pool.fault_hook = hook

    rows, strings, stats = _run(2, arm=kill_once)
    ref_rows, ref_strings = _inline()
    assert rows == ref_rows
    assert strings == ref_strings
    assert stats["repacks"] >= 1 and stats["deaths"] == 1
    assert stats["alive"] == 2             # respawned on a later submit


def test_columns_path_bit_identity():
    def run(pool):
        m = _manager(pool)
        rt = m.create_siddhi_app_runtime(APP)
        c = make_collector(siddhi_tpu_torch.StreamCallback)
        rt.add_callback("Out", c)
        h = rt.get_input_handler("S")
        rng = np.random.default_rng(11)
        ts = 0
        for b in range(4):
            n = 900
            keys = rng.integers(0, 30 + 30 * b, n)
            syms = np.array([f"C{k}" for k in keys], dtype=object)
            syms[7] = None
            h.send_columns({"sym": syms, "v": np.round(rng.random(n), 6),
                            "n": np.arange(n, dtype=np.int64)},
                           timestamps=np.arange(ts, ts + n, dtype=np.int64))
            ts += n
        strings = list(rt.app_context.string_dictionary._to_str)
        used = rt.app_context.ingest_pack_pool.subbatches if pool else 0
        m.shutdown()
        return c.rows, strings, used

    r0, s0, _ = run(0)
    r2, s2, used = run(2)
    assert r0 == r2 and len(r0) > 0
    assert s0 == s2
    assert used > 0


def test_small_batches_stay_inline():
    m = _manager(4, split=8192)
    rt = m.create_siddhi_app_runtime(APP)
    rt.add_callback("Out", make_collector(siddhi_tpu_torch.StreamCallback))
    h = rt.get_input_handler("S")
    h.send([Event(timestamp=i, data=["a", 1.0, i]) for i in range(64)])
    assert rt.app_context.ingest_pack_pool.subbatches == 0
    m.shutdown()


@pytest.mark.parametrize("key,value", [("ingest_pool", "many"), ("ingest_split", "1e3x")])
def test_ingest_knob_junk_raises(key, value):
    m = siddhi_tpu_torch.SiddhiManager(device="cpu")
    m.set_config_manager(siddhi_tpu_torch.InMemoryConfigManager(
        {f"siddhi_tpu.{key}": value}))
    with pytest.raises(SiddhiAppValidationException, match=key):
        m.create_siddhi_app_runtime(APP)
