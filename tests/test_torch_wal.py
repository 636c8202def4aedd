"""The ingest WAL (``resilience/replay.py``) on the port, on the CPU.

The WAL scenarios of ``tests/test_resilience.py`` (bounds, the cut/trim
protocol, effectively-once restore plus replay, columnar records with
resolved timestamps, the @Async drain before the cut, replay behind the
@app:enforceOrder watermark) and of ``tests/test_ingest_pool.py`` (replay
with the ingest pool), written as port tests with the same feeds and
checks: that module imports the supervisor and the fault injector (ROADMAP
A.10) at its top. Each scenario runs through both packages (``pkg``), and
the port's output rows equal the reference's (floats to 1e-12, the
tolerance rule of ``torch_helpers``; within a package, exactly). Also: a WAL record owns its
columns, so a producer that reuses its buffer replays the data it sent;
and a wire frame's string ids replay against the restored dictionary.
"""

import types

import numpy as np
import pytest

from torch_helpers import assert_rows_match, release_jax_programs  # noqa: F401 — autouse fixture

PKGS = ("jax", "torch")


def _pkg(name):
    if name == "jax":
        import siddhi_tpu as p
        from siddhi_tpu.core.event import Event
        from siddhi_tpu.core.util.config import InMemoryConfigManager
        from siddhi_tpu.core.util.persistence import InMemoryPersistenceStore
        from siddhi_tpu.resilience.replay import IngestWAL

        manager = p.SiddhiManager
    else:
        import functools

        import siddhi_tpu_torch as p
        from siddhi_tpu_torch import InMemoryConfigManager
        from siddhi_tpu_torch.core.event import Event
        from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore
        from siddhi_tpu_torch.resilience.replay import IngestWAL

        manager = functools.partial(p.SiddhiManager, device="cpu")

    class Collector(p.StreamCallback):
        def __init__(self):
            super().__init__()
            self.events = []

        def receive(self, events):
            self.events.extend(events)

        def rows(self):
            return [(e.timestamp, *e.data) for e in self.events]

    return types.SimpleNamespace(
        Manager=manager, Config=InMemoryConfigManager, Event=Event,
        Store=InMemoryPersistenceStore, IngestWAL=IngestWAL,
        Collector=Collector)


def _assert_same_rows(got, want, atol=0.0):
    """(ts, *data) rows of the two packages, under the tolerance rule."""
    assert_rows_match([(r[0], list(r[1:]), False) for r in got],
                      [(r[0], list(r[1:]), False) for r in want], atol=atol)


def _wait_for(predicate, timeout=15.0):
    import time

    t0 = time.time()
    while time.time() - t0 < timeout:
        if predicate():
            return True
        time.sleep(0.01)
    return False


APP_SUM = """
    @app:name('walApp')
    define stream S (sym string, v long);
    @info(name = 'q')
    from S#window.length(4)
    select sym, sum(v) as total
    group by sym
    insert into Out;
"""
APP_ASYNC = """
    @app:name('asyncPersist')
    @Async(buffer.size='512', batch.size='32')
    define stream S (sym string, v long);
    @info(name = 'q')
    from S#window.length(4)
    select sym, sum(v) as total group by sym
    insert into Out;
"""
APP_ORDER = """
    @app:name('orderApp')
    @app:enforceOrder
    define stream S (sym string, v long);
    @info(name = 'q')
    from S#window.length(4)
    select sym, sum(v) as total group by sym
    insert into Out;
"""
SEG_A = [(1000 + i, [f"K{i % 3}", i]) for i in range(6)]
SEG_B = [(2000 + i, [f"K{i % 3}", 10 + i]) for i in range(5)]
SEG_C = [(3000 + i, [f"K{i % 3}", 100 + i]) for i in range(5)]


def _uninterrupted_rows(P, sends, app=APP_SUM):
    m = P.Manager()
    rt = m.create_siddhi_app_runtime(app)
    c = P.Collector()
    rt.add_callback("Out", c)
    h = rt.get_input_handler("S")
    for ts, data in sends:
        h.send(ts, list(data))
    m.shutdown()
    return c.rows()


@pytest.mark.parametrize("pkg", PKGS)
def test_wal_bounds_drop_oldest_and_count(pkg):
    P = _pkg(pkg)
    wal = P.IngestWAL(max_batches=3)
    for i in range(5):
        wal.record_events("S", [P.Event(timestamp=i, data=[i])])
    assert len(wal) == 3
    assert wal.dropped_batches == 2
    assert wal.recorded_batches == 5
    # the retained suffix is the newest three
    assert [r.payload[0].timestamp for r in wal._log] == [2, 3, 4]


@pytest.mark.parametrize("pkg", PKGS)
def test_wal_cut_trim_protocol_keeps_post_cut_batches(pkg):
    P = _pkg(pkg)
    wal = P.IngestWAL(max_batches=100)
    wal.record_events("S", [P.Event(timestamp=1, data=[1])])
    cut = wal.cut()
    wal.record_events("S", [P.Event(timestamp=2, data=[2])])  # after capture
    assert wal.trim(cut) == 1
    assert len(wal) == 1               # the in-between batch survived
    assert wal._log[0].payload[0].timestamp == 2


def _checkpoint_restore_replay(P):
    store = P.Store()
    m1 = P.Manager()
    m1.set_persistence_store(store)
    rt1 = m1.create_siddhi_app_runtime(APP_SUM)
    c1 = P.Collector()
    rt1.add_callback("Out", c1)
    wal = rt1.enable_wal()
    h = rt1.get_input_handler("S")
    for ts, data in SEG_A:
        h.send(ts, list(data))
    rt1.persist()
    assert len(wal) == 0               # the checkpoint trimmed the prefix
    for ts, data in SEG_B:
        h.send(ts, list(data))
    assert len(wal) == len(SEG_B)      # the suffix is retained
    rows_before = c1.rows()
    m1.shutdown()

    # a fresh runtime restores the revision and replays the suffix
    m2 = P.Manager()
    m2.set_persistence_store(store)
    rt2 = m2.create_siddhi_app_runtime(APP_SUM)
    c2 = P.Collector()
    rt2.add_callback("Out", c2)
    rt2.app_context.ingest_wal = wal   # the survivor hands over its log
    assert rt2.restore_last_revision() is not None
    h2 = rt2.get_input_handler("S")
    for ts, data in SEG_C:
        h2.send(ts, list(data))
    m2.shutdown()
    expected = _uninterrupted_rows(P, SEG_A + SEG_B + SEG_C)
    got = rows_before[:len(SEG_A)] + c2.rows()
    assert got == expected
    return got


def test_checkpoint_trims_wal_and_restore_replays_suffix():
    """Effectively-once across runtimes, in both packages: the restored
    checkpoint plus the replayed suffix reproduce the uninterrupted
    output stream, and the port's rows equal the reference's."""
    rows = {pkg: _checkpoint_restore_replay(_pkg(pkg)) for pkg in PKGS}
    _assert_same_rows(rows["torch"], rows["jax"])


@pytest.mark.parametrize("pkg", PKGS)
def test_wal_records_columnar_batches_with_resolved_timestamps(pkg):
    P = _pkg(pkg)
    m = P.Manager()
    rt = m.create_siddhi_app_runtime(APP_SUM)
    wal = rt.enable_wal()
    c = P.Collector()
    rt.add_callback("Out", c)
    h = rt.get_input_handler("S")
    h.send_columns({"sym": np.array(["a", "b"], object),
                    "v": np.array([1, 2], np.int64)})
    assert len(wal) == 1
    rec = wal._log[0]
    assert rec.kind == "columns" and rec.size == 2
    # a default-stamped batch records its resolved ingest time, so a
    # replay lands at its original place in event time
    assert rec.timestamps is not None and rec.timestamps.dtype == np.int64
    m.shutdown()


def _persist_drains_async(P):
    store = P.Store()
    m1 = P.Manager()
    m1.set_persistence_store(store)
    rt1 = m1.create_siddhi_app_runtime(APP_ASYNC)
    c1 = P.Collector()
    rt1.add_callback("Out", c1)
    wal = rt1.enable_wal()
    h = rt1.get_input_handler("S")
    for ts, data in SEG_A:
        h.send(ts, list(data))
    rt1.persist()          # the queue may still hold every batch: drained
    assert len(wal) == 0, "a drained checkpoint trims the whole log"
    for ts, data in SEG_B:
        h.send(ts, list(data))
    assert _wait_for(lambda: len(c1.events) == len(SEG_A) + len(SEG_B))
    m1.shutdown()

    m2 = P.Manager()
    m2.set_persistence_store(store)
    rt2 = m2.create_siddhi_app_runtime(APP_ASYNC)
    c2 = P.Collector()
    rt2.add_callback("Out", c2)
    rt2.app_context.ingest_wal = wal
    assert rt2.restore_last_revision() is not None
    assert _wait_for(lambda: len(c2.events) == len(SEG_B))
    m2.shutdown()
    # nothing lost at the cut, nothing doubled by the replay
    expected = _uninterrupted_rows(P, SEG_A + SEG_B)
    got = c1.rows()[:len(SEG_A)] + c2.rows()
    assert got == expected
    return got


def test_persist_drains_async_queue_before_wal_cut():
    rows = {pkg: _persist_drains_async(_pkg(pkg)) for pkg in PKGS}
    _assert_same_rows(rows["torch"], rows["jax"])


@pytest.mark.parametrize("pkg", PKGS)
def test_wal_replay_bypasses_enforce_order_watermark(pkg):
    """An in-process restore rewinds state but not the InputHandler's
    watermark; the replayed suffix re-enters with its original (older)
    timestamps and is not refused."""
    P = _pkg(pkg)
    store = P.Store()
    m = P.Manager()
    m.set_persistence_store(store)
    rt = m.create_siddhi_app_runtime(APP_ORDER)
    c = P.Collector()
    rt.add_callback("Out", c)
    rt.enable_wal()
    h = rt.get_input_handler("S")
    for ts, data in SEG_A:
        h.send(ts, list(data))
    rev = rt.persist()
    for ts, data in SEG_B:
        h.send(ts, list(data))
    n_live = len(c.events)
    rt.restore_revision(rev)       # replays SEG_B behind the watermark
    assert len(c.events) == n_live + len(SEG_B)
    replayed = [(e.timestamp, *e.data) for e in c.events[n_live:]]
    expected = _uninterrupted_rows(P, SEG_A + SEG_B)[len(SEG_A):]
    assert replayed == expected
    # live ingest continues under the kept watermark
    with pytest.raises(ValueError, match="enforceOrder"):
        h.send(1, ["late", 0])
    m.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_restore_of_an_older_revision_skips_the_replay(pkg):
    """The stale-revision rule: the retained suffix follows the newest
    checkpoint; restoring an older revision leaves the log alone."""
    P = _pkg(pkg)
    m = P.Manager()
    m.set_persistence_store(P.Store())
    rt = m.create_siddhi_app_runtime(APP_SUM)
    c = P.Collector()
    rt.add_callback("Out", c)
    wal = rt.enable_wal()
    h = rt.get_input_handler("S")
    for ts, data in SEG_A:
        h.send(ts, list(data))
    old = rt.persist()
    for ts, data in SEG_B:
        h.send(ts, list(data))
    rt.persist()
    for ts, data in SEG_C:
        h.send(ts, list(data))
    n = len(c.events)
    rt.restore_revision(old)
    assert len(c.events) == n          # no replay onto the older base
    assert len(wal) == len(SEG_C)      # and the log is kept
    m.shutdown()


POOL_APP = """
@app:enforceOrder
define stream S (sym string, v double, n long);
@info(name='q') from S#window.length(64)
  select sym, sum(v) as sv, count() as c group by sym
  insert into Out;
"""


def _pool_batches(P, n_batches=5, rows=700, seed=3):
    rng = np.random.default_rng(seed)
    out, ts = [], 0
    for b in range(n_batches):
        keys = rng.integers(0, 15 + 25 * b, rows)   # new strings per batch
        evs = []
        for i in range(rows):
            sym = None if i % 97 == 5 else f"K{keys[i]}"
            evs.append(P.Event(timestamp=ts, data=[
                sym, float(np.round(rng.random() * 10, 6)), int(i)]))
            ts += 1
        out.append(evs)
    return out


def _pool_manager(P, pool):
    m = P.Manager()
    m.set_config_manager(P.Config({"siddhi_tpu.ingest_pool": str(pool),
                                   "siddhi_tpu.ingest_split": "128"}))
    return m


def _replay_with_pool(P):
    batches = _pool_batches(P)
    m0 = _pool_manager(P, 0)
    rt0 = m0.create_siddhi_app_runtime(POOL_APP)
    c0 = P.Collector()
    rt0.add_callback("Out", c0)
    h0 = rt0.get_input_handler("S")
    for evs in _pool_batches(P):
        h0.send(evs)
    m0.shutdown()
    expected = c0.rows()

    store = P.Store()
    m1 = _pool_manager(P, 2)
    m1.set_persistence_store(store)
    rt1 = m1.create_siddhi_app_runtime(POOL_APP)
    c1 = P.Collector()
    rt1.add_callback("Out", c1)
    wal = rt1.enable_wal()
    h = rt1.get_input_handler("S")
    for evs in batches[:2]:
        h.send(evs)
    rt1.persist()
    for evs in batches[2:4]:
        h.send(evs)
    assert len(wal) == 2
    rows_before = c1.rows()
    m1.shutdown()

    m2 = _pool_manager(P, 2)
    m2.set_persistence_store(store)
    rt2 = m2.create_siddhi_app_runtime(POOL_APP)
    c2 = P.Collector()
    rt2.add_callback("Out", c2)
    rt2.app_context.ingest_wal = wal
    assert rt2.restore_last_revision() is not None
    h2 = rt2.get_input_handler("S")
    for evs in batches[4:]:
        h2.send(evs)
    m2.shutdown()
    assert rows_before == expected[:len(rows_before)]
    # the checkpoint covered batches 0-1 (one row out per event in); the
    # new runtime replays batches 2-3 once and continues live
    n_checkpoint = 2 * 700
    got = rows_before[:n_checkpoint] + c2.rows()
    assert got == expected
    return got


def test_wal_replay_after_restore_bit_identical_with_pool():
    """persist -> crash -> restore + replay with the ingest pool at 2
    reproduces the uninterrupted pool-0 stream exactly, in both packages,
    and the port's rows equal the reference's."""
    rows = {pkg: _replay_with_pool(_pkg(pkg)) for pkg in PKGS}
    # sum(v) over length(64) adds and subtracts values up to 10 as rows
    # enter and leave: the packages' running sums differ by rounding of
    # the window's magnitude (~1e-13 absolute), which a small sum shows
    # as a large relative error
    _assert_same_rows(rows["torch"], rows["jax"], atol=1e-9)


@pytest.mark.parametrize("pkg", PKGS)
def test_wal_record_owns_a_reused_buffer(pkg):
    """A producer that reuses one column buffer for two batches of
    different values: the WAL replays each batch as it was sent, not the
    buffer's later contents."""
    P = _pkg(pkg)
    sym = np.array(["K0", "K1", "K2", "K0"], object)

    def batch(b):
        return np.arange(4, dtype=np.int64) + 10 * (b + 1), \
            np.arange(4, dtype=np.int64) + 1000 * (b + 1)

    # the rows of the two batches, each sent in fresh arrays
    m0 = P.Manager()
    rt0 = m0.create_siddhi_app_runtime("@app:playback\n" + APP_SUM)
    c0 = P.Collector()
    rt0.add_callback("Out", c0)
    h0 = rt0.get_input_handler("S")
    h0.send(500, ["K0", 1])
    for b in range(2):
        v, ts = batch(b)
        h0.send_columns({"sym": sym.copy(), "v": v}, timestamps=ts)
    m0.shutdown()
    want = c0.rows()[1:]

    m = P.Manager()
    m.set_persistence_store(P.Store())
    rt = m.create_siddhi_app_runtime("@app:playback\n" + APP_SUM)
    c = P.Collector()
    rt.add_callback("Out", c)
    wal = rt.enable_wal()
    h = rt.get_input_handler("S")
    h.send(500, ["K0", 1])
    rev = rt.persist()
    v_buf = np.zeros(4, np.int64)
    ts_buf = np.zeros(4, np.int64)
    for b in range(2):
        v_buf[:], ts_buf[:] = batch(b)       # the same buffers, new values
        h.send_columns({"sym": sym, "v": v_buf}, timestamps=ts_buf)
    v_buf[:] = -1                            # scribbled after the sends
    ts_buf[:] = 0
    first_pass = c.rows()[1:]
    assert first_pass == want and len(want) == 8
    assert len(wal) == 2
    rt.restore_revision(rev)
    replayed = c.rows()[1 + len(first_pass):]
    assert replayed == want
    m.shutdown()


def test_wal_replays_wire_ids_against_the_restored_dictionary():
    """A decoded wire frame carries its strings as dictionary ids. A string
    first seen after the revision has an id the restore rolls back, so the
    WAL records the strings and the replay re-encodes them, to the same
    ids. (The reference records the ids, and its replay would emit them
    dangling.)"""
    from siddhi_tpu_torch.core.stream.input.wire import (
        DecoderRegistry, WireEncoder, decode_frame)

    P = _pkg("torch")
    m = P.Manager()
    m.set_persistence_store(P.Store())
    rt = m.create_siddhi_app_runtime("@app:playback\n" + APP_SUM)
    c = P.Collector()
    rt.add_callback("Out", c)
    rt.enable_wal()
    h = rt.get_input_handler("S")
    enc, reg = WireEncoder(), DecoderRegistry()
    definition = rt.junctions["S"].definition
    dic = rt.app_context.string_dictionary

    def send(syms, t0):
        ts = np.arange(len(syms), dtype=np.int64) + t0
        frame = enc.encode({"sym": np.array(syms, object),
                            "v": np.arange(len(syms), dtype=np.int64)}, timestamps=ts)
        data, ts = decode_frame(frame, definition, dic, reg, scope=rt.name)
        assert np.issubdtype(np.asarray(data["sym"]).dtype, np.integer)
        h.send_columns(data, timestamps=ts)

    send(["a", "b", "a"], 1000)
    rev = rt.persist()
    send(["c", "a", "d"], 2000)             # c and d: new after the revision
    send(["d", "e", None], 3000)
    first = c.rows()[3:]
    rt.restore_revision(rev)
    assert c.rows()[3 + len(first):] == first
    assert [r[1] for r in first] == ["c", "a", "d", "d", "e", None]
    assert dic._to_str == ["a", "b", "c", "d", "e"]
    m.shutdown()
