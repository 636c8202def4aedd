"""The serving tier on the port (``serving/``: the sharded aggregation
stores, the scatter pool and admission, the REST front door), on the CPU.

- The 15 scenarios of ``tests/test_serving.py`` drive the port through
  the module's own feeds and checks (``torch_helpers.port_corpus``);
  ``test_device_views_epoch_cached_on_shard_devices`` asserts
  ``jax.Array``, so its checks run here on tensors of the runtime's
  device.
- The same seeded feed through both packages at ``agg_shards`` 4 and 1:
  the rows of every granularity equal, and every shard holds the same
  (bucket, group) set as the reference's shard of that index.
- Sharded revisions restore across the packages in both directions, into
  4, 3 and 1 shards.
"""

import functools

import numpy as np
import pytest
import torch

from torch_helpers import port_corpus, release_jax_programs  # noqa: F401 — autouse fixture

MOD, _ALL = port_corpus("test_serving")
JAX_ONLY = "test_device_views_epoch_cached_on_shard_devices"
SCENARIOS = [n for n in _ALL if n != JAX_ONLY]


def test_every_scenario_is_collected():
    """15 scenarios: 14 run as written, one through its tensor version."""
    assert len(_ALL) == 15 and JAX_ONLY in _ALL, _ALL


@pytest.mark.parametrize("name", SCENARIOS)
def test_serving_corpus_on_port(name):
    getattr(MOD, name)()


def test_device_views_epoch_cached_on_shard_devices():
    """The reference scenario's checks on tensors: each shard's view is
    on the runtime's device, cached until a fold bumps its epoch, and
    equals the shard's columnized rows."""
    m, rt = MOD._mk(4)
    try:
        MOD._pump(rt, seed=21, n=80)
        agg = rt.aggregations["TradeAgg"]
        d = agg.durations[0]
        views = [agg.shard_device_contents(i, d) for i in range(4)]
        for i, (defn, cols, valid) in enumerate(views):
            arr = cols["total"]
            assert isinstance(arr, torch.Tensor)
            assert arr.device == agg.shards[i].device == rt.app_context.device
            _d, want, want_valid = agg._columnize(
                agg._rows_from_items(agg.shards[i].partials(d)))
            assert torch.equal(valid, torch.from_numpy(want_valid))
            for k, v in want.items():
                np.testing.assert_array_equal(cols[k].numpy(), v, err_msg=k)
        # cached until the next fold bumps the epoch
        assert agg.shard_device_contents(0, d) is views[0]
        rt.get_input_handler("TradeStream").send(["S0", 1.0, 1, 1])
        owner = agg._owner_of((rt.app_context.string_dictionary.encode("S0"),))
        assert agg.shard_device_contents(owner, d) is not views[owner]
    finally:
        m.shutdown()


# ------------------------------------------------ the two packages, shard for shard

def _pkg(pkg):
    if pkg == "jax":
        import siddhi_tpu
        from siddhi_tpu.core.util.config import InMemoryConfigManager
        from siddhi_tpu.core.util.persistence import InMemoryPersistenceStore

        return siddhi_tpu.SiddhiManager, InMemoryConfigManager, InMemoryPersistenceStore
    import siddhi_tpu_torch
    from siddhi_tpu_torch import InMemoryConfigManager
    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore

    return (functools.partial(siddhi_tpu_torch.SiddhiManager, device="cpu"),
            InMemoryConfigManager, InMemoryPersistenceStore)


def _build(pkg, shards, store=None):
    manager, cfg, _store = _pkg(pkg)
    m = manager()
    m.set_config_manager(cfg({"siddhi_tpu.agg_shards": str(shards)}))
    if store is not None:
        m.set_persistence_store(store)
    return m, m.create_siddhi_app_runtime(MOD.APP)


def _feed(seed, batches=3, n=64, keys=23):
    """Seeded column batches of TradeStream (strings, doubles, longs,
    event-time longs across seconds to days)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        out.append({"symbol": np.array([f"S{k}" for k in rng.integers(0, keys, n)], object),
                    "price": np.round(rng.random(n) * 100.0, 3),
                    "volume": rng.integers(1, 5, n).astype(np.int64),
                    "ts": rng.integers(0, 3 * 86_400_000, n).astype(np.int64)})
    return out


def _send(rt, feed):
    h = rt.get_input_handler("TradeStream")
    for cols in feed:
        h.send_columns(cols)


PERS = ("seconds", "minutes", "hours", "days", "months", "years")


def _all_rows(rt):
    return {per: MOD._rows(rt, per) for per in PERS}


def _shard_keys(agg):
    """Per shard, per duration: the set of (bucket, group) it holds."""
    return [{d.value: {(b, g) for b, groups in s.store.get(d, {}).items() for g in groups}
             for d in agg.durations} for s in agg.shards]


@pytest.mark.parametrize("shards", [4, 1])
def test_rows_and_shards_equal_the_reference(shards):
    feed = _feed(7)
    got, want = {}, {}
    for pkg, out in (("torch", got), ("jax", want)):
        m, rt = _build(pkg, shards)
        _send(rt, feed)
        out["rows"] = _all_rows(rt)
        agg = rt.aggregations["TradeAgg"]
        out["n"] = getattr(agg, "n_shards", 1)
        out["keys"] = _shard_keys(agg) if shards > 1 else None
        out["strings"] = list(rt.app_context.string_dictionary._to_str)
        m.shutdown()
    assert got["n"] == want["n"] == shards
    assert got["strings"] == want["strings"]      # the same dictionary ids
    for per in PERS:
        assert got["rows"][per] == want["rows"][per], per
        assert got["rows"][per], per
    if shards > 1:
        assert got["keys"] == want["keys"]
        assert all(k["sec"] for k in got["keys"])  # every shard owns a slice


DIRECTIONS = [("jax", "torch", 4), ("jax", "torch", 3), ("torch", "jax", 4),
              ("torch", "jax", 1), ("torch", "torch", 3)]


@pytest.mark.parametrize("src,dst,dst_shards", DIRECTIONS,
                         ids=[f"{a}-4-to-{b}-{n}" for a, b, n in DIRECTIONS])
def test_sharded_revision_restores_across_packages(src, dst, dst_shards):
    """A revision persisted at 4 shards by one package restores into the
    other (or the port at another shard count); the tail of the feed then
    gives the rows an uninterrupted 4-shard run of the restoring package
    gives."""
    feed = _feed(11, batches=4)
    _m, _c, Store = _pkg(src)
    src_store = Store()
    m, rt = _build(src, 4, src_store)
    _send(rt, feed[:2])
    rev = rt.persist()
    name = rt.name
    m.shutdown()

    _m, _c, Store = _pkg(dst)
    dst_store = Store()
    dst_store.save(name, rev, src_store.load(name, rev))
    m2, rt2 = _build(dst, dst_shards, dst_store)
    assert rt2.restore_last_revision() == rev
    _send(rt2, feed[2:])
    got = _all_rows(rt2)
    if dst_shards > 1:
        agg = rt2.aggregations["TradeAgg"]
        # every (bucket, group) re-routed to its owner at the new count
        for s_idx, keys in enumerate(_shard_keys(agg)):
            for d, pairs in keys.items():
                assert all(agg._owner_of(g) == s_idx for _b, g in pairs), (s_idx, d)
    m2.shutdown()

    m3, rt3 = _build(dst, 4)
    _send(rt3, feed)
    want = _all_rows(rt3)
    m3.shutdown()
    assert got == want
