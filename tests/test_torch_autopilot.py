"""The port's autopilot (``siddhi_tpu_torch/autopilot/``) against the
reference's, on the CPU.

- The fifteen contracts of ``tests/test_autopilot.py`` run on the port
  through the module's own apps, feeds and checks
  (``torch_helpers.port_corpus``): default off, dry run, on with cooldown,
  the compile storm, damping, bounds, live actuations, the reshard
  straddling a persist and restore exactly once, the join Wp shrink after
  skew, the metric families, ``GET /autopilot`` and the bounded log.
- The same seeded ``SignalSnapshot`` sequences go to both packages'
  ``Policy`` under one manual clock, through cooldowns, damping and
  compile-storm freezes: every verdict is equal.
- Actuated port runs give the reference's rows on the same feed: the live
  actuation schedule, the controller under live ingest, the reshard
  2 -> 4 -> persist -> restore -> DOWN, and the join shrink (floats to
  rtol 1e-12).
- ``route_shards`` steps 2 -> 4 -> 8 on one device (logical shards: no
  card count caps it), a re-install leaves the program cache as it found
  it, a tick reads no tensor's values, and registration holds one
  journey ref for the app's life.
"""

import importlib
import inspect

import numpy as np
import pytest

from torch_helpers import (FLOAT_RTOL, port_corpus,  # noqa: F401 — autouse fixture
                           release_jax_programs)

MOD, _ = port_corpus("test_autopilot")
REF = importlib.import_module("test_autopilot")
# every contract, those taking ``monkeypatch`` too
CONTRACTS = sorted(k for k, v in vars(MOD).items()
                   if k.startswith("test_") and callable(v))


def test_every_contract_is_collected():
    assert len(CONTRACTS) == 15, CONTRACTS


@pytest.mark.parametrize("name", CONTRACTS)
def test_autopilot_contract_on_port(name, monkeypatch):
    fn = getattr(MOD, name)
    if inspect.signature(fn).parameters:
        fn(monkeypatch)
    else:
        fn()


# ------------------------------------------------------------ policy


def _snapshot_kwargs(rng):
    """One seeded observation: bottlenecks, depth, pool, quotas, join
    shrink candidates, routed shard counts, fused groups."""
    stages = ("device", "pack", "dispatch", "queue", None)
    bottlenecks = {}
    for q in ("q1", "q2")[: int(rng.integers(0, 3))]:
        stage = stages[int(rng.integers(0, len(stages)))]
        bottlenecks[q] = {} if stage is None else {
            "stage": stage, "utilization": float(rng.choice(
                [0.01, 0.1, 0.2, 0.35, 0.6, 0.95, float(rng.random())]))}
    kw = {"app": "a", "bottlenecks": bottlenecks,
          "pipeline_depth": int(rng.integers(1, 9)),
          "fused_groups": int(rng.integers(0, 2))}
    if rng.random() < 0.5:
        kw["pool_workers"] = int(rng.integers(0, 9))
        kw["pool_utilization"] = float(rng.random())
    if rng.random() < 0.5:
        kw["quota"] = {"queue_utilization.S": float(rng.choice(
            [0.1, 0.5, 0.95, float(rng.random())]))}
    if rng.random() < 0.3:
        kw["join_shrinkable"] = {"j": {"left": (16, 8)}}
    if rng.random() < 0.5:
        kw["routed"] = {"q1": int(rng.choice([2, 4, 8]))}
    return kw


def _verdicts(policy, snapshot, now):
    return [(v["rule"].name, v["rule"].actuator, v["direction"], v["blocked"])
            for v in policy.decide(snapshot, now)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_verdicts_equal_the_reference(seed):
    from siddhi_tpu.autopilot.policy import Policy as RefPolicy
    from siddhi_tpu.autopilot.signals import SignalSnapshot as RefSnapshot
    from siddhi_tpu_torch.autopilot.policy import Policy
    from siddhi_tpu_torch.autopilot.signals import SignalSnapshot

    rng = np.random.default_rng(seed)
    ref, port = RefPolicy(cooldown_s=5.0), Policy(cooldown_s=5.0)
    now, compiles = 1000.0, 0
    seen = {"cooldown": 0, "damped": 0, None: 0, "frozen": 0}
    for _ in range(300):
        now += float(rng.choice([0.5, 1.0, 3.0, 6.0, 11.0]))
        if rng.random() < 0.15:
            compiles += int(rng.integers(1, 4))      # a compile storm tick
        frozen = ref.observe_compiles(compiles)
        assert port.observe_compiles(compiles) is frozen
        assert port.frozen is ref.frozen
        if frozen:
            seen["frozen"] += 1
            continue
        kw = _snapshot_kwargs(rng)
        want = _verdicts(ref, RefSnapshot(**kw), now)
        got = _verdicts(port, SignalSnapshot(**kw), now)
        assert got == want
        for _rule, actuator, direction, blocked in want:
            seen[blocked] += 1
            if blocked is None and rng.random() < 0.7:
                ref.applied(actuator, direction, now)
                port.applied(actuator, direction, now)
        for name in ("pipeline_depth", "route_shards"):
            assert port.bounds_ok(name, 8) == ref.bounds_ok(name, 8)
    # the sequence went through every branch of the hysteresis
    assert all(n > 0 for n in seen.values()), seen


# ------------------------------------------------------ actuated rows


def _close_rows(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=FLOAT_RTOL, abs=0.0), (g, w)
            else:
                assert a == b, (g, w)


def _multi_rows(mod, feed, step=None):
    m, rt, sinks = mod._build()
    h = rt.get_input_handler("S")
    for i, (data, ts) in enumerate(feed):
        h.send_columns({k: v.copy() for k, v in data.items()}, timestamps=ts.copy())
        if step is not None:
            step(rt, i)
    out = mod._rows(sinks)
    m.shutdown()
    return out


def test_live_actuations_give_the_reference_rows():
    """The reference's live schedule (depth, ingest pool, fusion at batch
    boundaries) on the port == the reference's unactuated rows."""
    from siddhi_tpu_torch.autopilot import ACTUATORS
    from siddhi_tpu_torch.autopilot.actuators import DOWN, UP

    schedule = {2: ("pipeline_depth", UP), 4: ("ingest_pool", UP),
                5: ("fuse_fanout", DOWN), 7: ("pipeline_depth", DOWN),
                8: ("fuse_fanout", UP), 9: ("ingest_pool", UP),
                10: ("ingest_pool", DOWN)}
    feed = REF._chunks(n_chunks=12, rows=24)

    def step(rt, i):
        if i in schedule:
            name, direction = schedule[i]
            ACTUATORS[name].apply(rt, direction)

    got = _multi_rows(MOD, feed, step)
    want = _multi_rows(REF, feed)
    assert set(got) == set(want)
    for s in want:
        _close_rows(got[s], want[s])


def test_controller_on_gives_the_reference_rows():
    """The port's controller ON, ticked between chunks with no cooldown ==
    the reference with the autopilot off."""
    from siddhi_tpu_torch.autopilot import AutopilotController

    feed = REF._chunks(n_chunks=10, rows=24, seed=23)
    m, rt, sinks = MOD._build(extra={"siddhi_tpu.autopilot": "on",
                                     "siddhi_tpu.autopilot_interval_s": "3600",
                                     "siddhi_tpu.autopilot_cooldown_s": "0.0"})
    ctl = AutopilotController.instance()
    h = rt.get_input_handler("S")
    for data, ts in feed:
        h.send_columns({k: v.copy() for k, v in data.items()}, timestamps=ts.copy())
        ctl.tick(rt.name)
    assert ctl.report(rt.name)["apps"][rt.name]["ticks"] == len(feed)
    got = MOD._rows(sinks)
    m.shutdown()
    want = _multi_rows(REF, feed)
    for s in want:
        _close_rows(got[s], want[s])


def _route_columns(lo, hi):
    """``_route_feed``'s rows [lo, hi) as one column batch."""
    rng = np.random.default_rng(42)
    syms = rng.integers(0, 13, 1000)
    sides = rng.integers(0, 5, 1000)
    idx = np.arange(lo, hi)
    return {"sym": np.array([f"SYM{s}" for s in syms[lo:hi]], dtype=object),
            "side": np.array([f"SIDE{s}" for s in sides[lo:hi]], dtype=object),
            "price": (idx % 17).astype(np.float64) + 0.25,
            "volume": idx.astype(np.int64)}


def test_reshard_straddling_restore_gives_the_reference_rows():
    """Routed at 2 shards, UP to 4 after 100 events, persist after 200, a
    restore into a fresh 2-shard install, then after 300 DOWN refused at
    the floor of 2 and UP to 4 (the port fed 50-row batches): the port's
    rows == the reference's unrouted rows of the same 400 events."""
    from siddhi_tpu_torch.autopilot import ACTUATORS
    from siddhi_tpu_torch.autopilot.actuators import DOWN, UP
    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore

    def feed(rt, lo, hi):
        h = rt.get_input_handler("S")
        for a in range(lo, hi, 50):
            h.send_columns(_route_columns(a, a + 50))

    store = InMemoryPersistenceStore()
    m1, rt1, c1 = MOD._build_routed(store=store, shards=2)
    feed(rt1, 0, 100)
    assert ACTUATORS["route_shards"].apply(rt1, UP) == (2, 4)
    feed(rt1, 100, 200)
    rt1.persist()
    m1.shutdown()
    m2, rt2, c2 = MOD._build_routed(store=store, shards=2)
    rt2.restore_last_revision()
    feed(rt2, 200, 300)
    assert ACTUATORS["route_shards"].apply(rt2, DOWN) is None   # at its floor of 2
    assert ACTUATORS["route_shards"].apply(rt2, UP) == (2, 4)
    feed(rt2, 300, 400)
    m2.shutdown()

    m, rt, c = REF._build_routed()
    h = rt.get_input_handler("S")
    for lo in range(0, 400, 100):
        h.send_columns(_route_columns(lo, lo + 100))
    m.shutdown()
    _close_rows(c1.rows + c2.rows, c.rows)


def test_join_shrink_gives_the_reference_rows():
    """The join scenario's skew burst, the shrink after diverse traffic and
    the second burst on the port == the reference's rows of the same sends
    (consecutive sends of one stream batched there: a join emits per
    arriving row, so a run of one side's rows is one batch's rows)."""
    from siddhi_tpu.core.util.config import InMemoryConfigManager as RefConfig
    from siddhi_tpu_torch import InMemoryConfigManager
    from siddhi_tpu_torch.autopilot import ACTUATORS
    from siddhi_tpu_torch.autopilot.actuators import DOWN

    rng = np.random.default_rng(17)
    sends = []
    for i in range(400):             # the reference scenario's draws
        if 120 <= i < 280:
            sym = f"S{rng.integers(0, 16)}"
        else:
            hot = 0.7 if i < 120 else 0.8
            sym = "HOT" if rng.random() < hot else f"S{rng.integers(0, 4)}"
        sends.append(("L" if rng.random() < .5 else "R", sym, i))
    cfg = {"siddhi_tpu.join_engine": "device", "siddhi_tpu.join_partitions": "8",
           "siddhi_tpu.join_partition_slack": "1"}

    m = MOD.SiddhiManager()
    m.set_config_manager(InMemoryConfigManager(cfg))
    rt = m.create_siddhi_app_runtime(MOD.JOIN_SKEW_APP)
    c = MOD.Collector()
    rt.add_callback("Out", c)
    rt.start()
    for side, sym, i in sends:
        rt.get_input_handler(side).send([sym, i])
        if i == 279:
            eng = rt.query_runtimes["jq"].engine
            grown = max(p.Wp for p in eng.plans.values())
            shrunk = ACTUATORS["join_partitions"].apply(rt, DOWN)
            assert shrunk is not None and shrunk[1] < shrunk[0]
            assert any(p.Wp < grown for p in eng.plans.values())
    m.shutdown()

    runs = []
    for side, sym, i in sends:
        if runs and runs[-1][0] == side:
            runs[-1][1].append((sym, i))
        else:
            runs.append((side, [(sym, i)]))
    rm = REF.SiddhiManager()
    rm.set_config_manager(RefConfig(cfg))
    rrt = rm.create_siddhi_app_runtime(REF.JOIN_SKEW_APP)
    rc = REF.Collector()
    rrt.add_callback("Out", rc)
    rrt.start()
    for side, rows in runs:
        rrt.get_input_handler(side).send_columns({
            "sym": np.array([r[0] for r in rows], dtype=object),
            ("lv" if side == "L" else "rv"): np.array([r[1] for r in rows], np.int64)})
    rm.shutdown()
    assert c.rows == rc.rows


# --------------------------------------------------- port-side contracts


def test_route_shards_is_capped_by_logical_shards_not_cards():
    """2 -> 4 -> 8 on one device, then held at the default cap of 8
    logical shards; the ``route_shards`` knob caps lower. The card count
    (0 here, 1 on one H100) caps nothing."""
    import torch

    from siddhi_tpu_torch.autopilot import ACTUATORS
    from siddhi_tpu_torch.autopilot.actuators import DEFAULT_ROUTE_SHARDS, UP

    assert torch.cuda.device_count() < 2
    m, rt, _c = MOD._build_routed(shards=2)
    steps = [ACTUATORS["route_shards"].apply(rt, UP) for _ in range(3)]
    assert steps == [(2, 4), (4, DEFAULT_ROUTE_SHARDS), None]
    assert rt.query_runtimes["q"]._route_layout.n == DEFAULT_ROUTE_SHARDS == 8
    m.shutdown()
    m, rt, _c = MOD._build_routed(shards=2)
    rt.app_context.route_shards = 4
    assert [ACTUATORS["route_shards"].apply(rt, UP) for _ in range(2)] == [(2, 4), None]
    m.shutdown()


def test_reinstall_leaves_the_program_cache_as_it_found_it():
    """A 2 -> 4 -> 2 round trip between sends: the routed step's cache
    entry of each install is released by the next, so the entries after
    the trip are the ones before it, and the rows are unchanged."""
    from siddhi_tpu_torch.autopilot import ACTUATORS
    from siddhi_tpu_torch.autopilot.actuators import DOWN, UP
    from siddhi_tpu_torch.core.util import program_cache

    def entries():
        return sorted((e["family"], tuple(e["shared_by"]))
                      for e in program_cache.cache().snapshot()["entries"])

    def feed(rt, lo):
        rt.get_input_handler("S").send_columns(_route_columns(lo, lo + 50))

    program_cache.cache().drain()
    m, rt, c = MOD._build_routed(shards=2)
    feed(rt, 0)
    before = entries()
    assert ("device_routed", ("aproute",)) in before, before
    assert ACTUATORS["route_shards"].apply(rt, UP) == (2, 4)
    feed(rt, 50)
    assert ACTUATORS["route_shards"].apply(rt, DOWN) == (4, 2)
    feed(rt, 100)
    assert entries() == before
    m.shutdown()
    m0, rt0, c0 = MOD._build_routed()
    for lo in (0, 50, 100):
        feed(rt0, lo)
    m0.shutdown()
    assert c.rows == c0.rows


def test_a_tick_reads_no_tensor():
    """A dry-run tick over a routed app and a join app with journeys on
    reads no tensor's values (on the card each read is a device sync)."""
    from torch_helpers import no_tensor_reads

    from siddhi_tpu_torch import InMemoryConfigManager
    from siddhi_tpu_torch.autopilot import AutopilotController

    ctl = AutopilotController.instance()
    m, rt, _c = MOD._build_routed(shards=2)
    MOD._route_feed(rt, 0, 40)
    j = MOD.SiddhiManager()
    j.set_config_manager(InMemoryConfigManager({"siddhi_tpu.join_partitions": "4"}))
    jrt = j.create_siddhi_app_runtime(MOD.JOIN_SKEW_APP)
    jrt.start()
    for i in range(40):
        jrt.get_input_handler("L" if i % 2 else "R").send([f"S{i % 5}", i])
    for r in (rt, jrt):
        r.enable_autopilot(mode="dry_run", interval_s=3600)
    try:
        with no_tensor_reads():
            for r in (rt, jrt):
                ctl.tick(r.name, now=1000.0)
        assert ctl.report(rt.name)["apps"][rt.name]["ticks"] == 1
    finally:
        m.shutdown()
        j.shutdown()


def test_registration_holds_one_journey_ref_for_the_apps_life():
    """Mode off registers nothing and leaves journeys off; a registered
    app holds one journey ref until its shutdown."""
    from siddhi_tpu_torch.autopilot import AutopilotController
    from siddhi_tpu_torch.observability import journey

    ctl = AutopilotController.instance()
    assert not journey.enabled()
    m, rt, _s = MOD._build(extra={"siddhi_tpu.autopilot": "off"})
    assert rt.name not in ctl.report()["apps"] and not journey.enabled()
    m.shutdown()
    m, rt, _s = MOD._build(extra={"siddhi_tpu.autopilot": "dry_run",
                                  "siddhi_tpu.autopilot_interval_s": "3600"})
    assert rt.name in ctl.report()["apps"] and journey.enabled()
    m.shutdown()
    assert rt.name not in ctl.report()["apps"] and not journey.enabled()
