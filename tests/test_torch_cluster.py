"""The port's cluster fabric (``siddhi_tpu_torch/cluster/``) against the
reference's, on the CPU.

- Units through both packages: ``OrderedEgress`` driven by the same seeded
  completion orders, duplicates, stale emissions and forgets releases the
  same rows in the same order with the same counters; ``pack_data`` /
  ``unpack_data`` and ``RelayEncoder.encode_ids`` (and the relayed frame)
  are byte-equal; ``owner_of_key`` sends 10,000 seeded keys to the same
  workers. The reference's egress units and its hello-version check run
  on the port (``torch_helpers.port_corpus``).
- One 2-worker fabric, its workers on the CPU: the reference fabric
  test's three apps and feed (a split partitioned window app, a pinned
  filter app fed over the ingest socket, a split table app), a checkpoint
  after batch 2 and worker 1 killed after batch 4. The egress rows and
  the scatter-gather rows (direct and through ``POST /query``) equal the
  REFERENCE's single-process runs, exactly once; ``GET /cluster``, the
  ``/metrics`` JSON block and the ``siddhi_cluster_*`` families answer.
  Every wait is bounded; nothing is gated on timing.
"""

import importlib
import json
import socket
import urllib.request

import numpy as np
import pytest

from torch_helpers import port_corpus, release_jax_programs  # noqa: F401 — autouse fixture

MOD, _ = port_corpus("test_cluster")
REF = importlib.import_module("test_cluster")
# the corpus's units: no worker processes (its fabric scenario is the
# reference's own; the port's runs below against the reference's rows)
UNITS = sorted(k for k in vars(MOD) if k.startswith("test_")
               and k != "test_cluster_fabric_end_to_end_with_mid_feed_kill")


def test_every_unit_is_collected():
    assert len(UNITS) == 5, UNITS


@pytest.mark.parametrize("name", UNITS)
def test_cluster_unit_on_port(name):
    getattr(MOD, name)()


# ---------------------------------------------------------------- egress

def _egress_script(seed, n_seqs=40):
    """A seeded schedule over tags (seq, run): expect in order, emit and
    complete in a shuffled order, with replayed (duplicate) emits and
    acks, stale emits dropped by ``drop_pending`` and lost heads
    forgotten."""
    rng = np.random.default_rng(seed)
    tags = [(s, r) for s in range(1, n_seqs + 1) for r in range(int(rng.integers(1, 4)))]
    ops = [("expect", t) for t in tags]
    order = [tags[i] for i in rng.permutation(len(tags))]
    lost = {order[i] for i in rng.choice(len(order), 3, replace=False)}
    for t in order:
        rows = [[int(t[0] * 10 + t[1]), [f"k{t[0] % 5}", int(rng.integers(0, 99))]]
                for _ in range(int(rng.integers(0, 3)))]
        if t in lost:
            if rng.random() < 0.5:
                ops.append(("emit", t, rows))      # emitted, then never acked
            ops.append(("forget", t))
            continue
        if rng.random() < 0.3:
            ops.append(("emit", t, [[0, ["stale", 0]]]))   # a dead worker's
            ops.append(("drop_pending", t))
        ops.append(("emit", t, rows))
        ops.append(("complete", t))
        if rng.random() < 0.3:
            ops.append(("emit", t, rows))          # the replay's re-emission
            ops.append(("complete", t))
    return ops


def _run_egress(egress_cls, ops):
    e = egress_cls()
    results = []
    for op in ops:
        if op[0] == "expect":
            e.expect(op[1])
        elif op[0] == "emit":
            results.append(e.emit(op[1], "a", "Out", [tuple(r) for r in op[2]]))
        elif op[0] == "complete":
            results.append(e.complete(op[1]))
        else:
            getattr(e, op[0])(op[1])
        results.append(e.outstanding())
    return results, e.stream_rows("a", "Out"), e.counters(), e.wait_quiesced(0.1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_egress_releases_what_the_reference_releases(seed):
    from siddhi_tpu.cluster.egress import OrderedEgress as RefEgress
    from siddhi_tpu_torch.cluster.egress import OrderedEgress

    ops = _egress_script(seed)
    got, want = _run_egress(OrderedEgress, ops), _run_egress(RefEgress, ops)
    assert got == want
    results, rows, counters, quiesced = got
    assert quiesced and counters["duplicate_emits"] > 0 and rows


# -------------------------------------------------------------- protocol

def test_envelopes_and_relay_bytes_equal_the_reference():
    from siddhi_tpu.cluster import protocol as RP
    from siddhi_tpu.core.event import StringDictionary as RefDictionary
    from siddhi_tpu_torch.cluster import protocol as P
    from siddhi_tpu_torch.core.event import StringDictionary

    rng = np.random.default_rng(5)
    for seq, run, app, stream in ((0, 0, "a", "S"), (2 ** 40 + 7, 3, "cSplit", "Ping"),
                                  (9, 65_535, "é" * 10, "x" * 300)):
        frame = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
        body = P.pack_data(seq, run, app, stream, frame)
        assert body == RP.pack_data(seq, run, app, stream, frame)
        assert P.unpack_data(body) == RP.unpack_data(body) == (seq, run, app, stream, frame)
    assert P.jdump({"k": [1, 2.5, "x"]}) == RP.jdump({"k": [1, 2.5, "x"]})
    vals = (np.int64(3), np.float32(0.1), np.float64(2.5), np.bool_(True), "s", None)
    assert [P.py_value(v) for v in vals] == [RP.py_value(v) for v in vals]

    words = [f"w{i}" for i in range(50)]
    port_dict, ref_dict = StringDictionary(), RefDictionary()
    for w in words:
        port_dict.encode(w)
        ref_dict.encode(w)
    enc, ref_enc = P.RelayEncoder(port_dict), RP.RelayEncoder(ref_dict)
    ref_enc.encoder_id = enc.encoder_id
    for _ in range(4):   # the LUT grows and keeps earlier translations
        ids = rng.integers(-1, 50, 32).astype(np.int64)
        got, want = enc.encode_ids(ids), ref_enc.encode_ids(ids)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        data = {"k": ids, "v": rng.integers(0, 9, 32).astype(np.int64)}
        ts = np.arange(32, dtype=np.int64)
        assert P.encode_for_link(enc, dict(data), {"k"}, timestamps=ts) == \
            RP.encode_for_link(ref_enc, dict(data), {"k"}, timestamps=ts)


def test_owner_of_key_equals_the_reference():
    from siddhi_tpu.cluster.router import owner_of_key as ref_owner
    from siddhi_tpu_torch.cluster import owner_of_key

    rng = np.random.default_rng(11)
    keys = ([f"K{i}" for i in rng.integers(0, 10 ** 6, 4000)]
            + [int(i) for i in rng.integers(-10 ** 9, 10 ** 9, 3000)]
            + [float(x) for x in np.round(rng.random(2000) * 1e4, 3)]
            + ["é" + str(i) for i in range(1000)])
    assert len(keys) == 10_000
    for n in (1, 2, 3, 4, 7):
        assert [owner_of_key(k, n) for k in keys] == [ref_owner(k, n) for k in keys]


# ---------------------------------------------------------------- fabric

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read().decode()


def test_fabric_with_a_mid_feed_kill_equals_the_reference_single_process():
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.cluster import ClusterRuntime
    from siddhi_tpu_torch.cluster import protocol as P
    from siddhi_tpu_torch.core.stream.input.wire import (
        WireEncoder, decode_control, encode_hello)
    from siddhi_tpu_torch.observability import export
    from siddhi_tpu_torch.observability.telemetry import global_registry
    from siddhi_tpu_torch.service import SiddhiRestService

    batches = REF.BATCHES
    split_feeds = [("S", {"k": k, "tag": t, "v": v, "n": n}, ts)
                   for k, t, v, n, ts in batches]
    pinned_feeds = [("Ping", {"k": k, "v": v}, ts) for k, t, v, n, ts in batches]
    table_feeds = [("T", {"k": k, "n": n}, ts) for k, t, v, n, ts in batches]
    base_split, _ = REF._baseline(REF.APP_SPLIT, split_feeds)
    base_pinned, _ = REF._baseline(REF.APP_PINNED, pinned_feeds)
    _, base_q = REF._baseline(REF.APP_TABLE, table_feeds, query="from Tab select k, n")
    assert base_split and base_pinned and base_q

    c0 = dict(global_registry().snapshot()["counters"])
    cluster = ClusterRuntime(n_workers=2, heartbeat_s=0.2, device="cpu")
    try:
        cluster.wait_ready(60)
        cluster.deploy(REF.APP_SPLIT, partition_keys={"S": "k"}, sinks=["Out"])
        cluster.deploy(REF.APP_PINNED, sinks=["Out"])
        cluster.deploy(REF.APP_TABLE, partition_keys={"T": "k"}, sinks=[])
        stats = cluster.worker_stats()
        assert [s["device"] for s in stats.values()] == ["cpu", "cpu"]

        enc = WireEncoder()
        ing = P.MessageSocket(socket.create_connection(
            ("127.0.0.1", cluster.ingest_port), timeout=30))
        ing.send(P.MSG_HELLO, encode_hello())
        assert ing.recv()[0] == P.MSG_HELLO
        last_seq = 0
        for i, (k, t, v, n, ts) in enumerate(batches):
            cluster.send_columns("cSplit", "S", {"k": k, "tag": t, "v": v, "n": n},
                                 timestamps=ts)
            ing.send(P.MSG_INGEST, P.pack_data(
                0, 0, "cPinned", "Ping", enc.encode({"k": k, "v": v}, timestamps=ts)))
            mtype, body = ing.recv()
            assert mtype == P.MSG_INGEST_ACK
            seq = decode_control(body).b
            assert seq > last_seq
            last_seq = seq
            cluster.send_columns("cTable", "T", {"k": k, "n": n}, timestamps=ts)
            if i == 1:
                cluster.checkpoint(timeout=60)
            if i == 3:
                cluster.supervisor.kill(1)
        ing.close()
        assert cluster.quiesce(120), "egress never quiesced"

        got_split = [(ts, tuple(v)) for ts, v in cluster.egress.stream_rows("cSplit", "Out")]
        got_pinned = [(ts, tuple(v)) for ts, v in cluster.egress.stream_rows("cPinned", "Out")]
        got_q = sorted(vals for _ts, vals in cluster.query("cTable", "from Tab select k, n",
                                                           timeout=60))
        assert got_split == base_split
        assert got_pinned == base_pinned
        assert got_q == base_q
        assert sum(cluster.supervisor.respawns) >= 1

        svc = SiddhiRestService(SiddhiManager(device="cpu"), cluster=cluster).start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{svc.port}/query",
                data=json.dumps({"app": "cTable", "query": "from Tab select k, n"}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert sorted(json.loads(r.read())["rows"]) == base_q
            code, body = _get(svc.port, "/cluster")
            st = json.loads(body)
            assert code == 200 and st["live"] == 2 and st["device"] == "cpu"
            assert st["apps"]["cTable"]["mode"] == "split"
            assert st["apps"]["cPinned"]["mode"] == "pinned"
            assert {w["device"] for w in st["per_worker"].values()} == {"cpu"}
            code, body = _get(svc.port, "/metrics?format=json")
            assert code == 200 and json.loads(body)["cluster"]["workers"] == 2
            text = export.prometheus_text(svc.manager)
            for family in ("siddhi_cluster_workers_live 2",
                           'siddhi_cluster_worker_respawns_total{worker="1"}',
                           "siddhi_cluster_checkpoints_total",
                           'siddhi_cluster_worker_acked_seq{worker="0"}'):
                assert family in text, family
        finally:
            svc.stop()
            svc.manager.shutdown()
        c1 = global_registry().snapshot()["counters"]
        assert c1["cluster.ingest_batches"] - c0.get("cluster.ingest_batches", 0) == \
            3 * len(batches)
        assert c1["cluster.checkpoints"] - c0.get("cluster.checkpoints", 0) == 1
    finally:
        cluster.shutdown()
    assert "cluster.workers.live" not in global_registry().snapshot()["gauges"]


def test_peer_monitor_declares_deaths_as_the_reference_does():
    """Both packages' ``PeerMonitor`` over the same sequence: a live peer
    seen, a never-reached address (not up yet, never dead), the peer's
    listener closed (dead after ``misses`` probes, reported once), a
    rearm (not up yet again) and an unwatch."""
    import siddhi_tpu.resilience.supervisor as ref_sup
    from siddhi_tpu_torch.resilience import PeerMonitor

    def trace(cls):
        mon = cls(probe_timeout_s=0.2, misses=2)
        # the peer: a plain listener (a killed process's listener refuses
        # at once; a listener closed under its own accept thread may not)
        peer = socket.socket()
        peer.bind(("127.0.0.1", 0))
        peer.listen(8)
        spare = socket.socket()
        spare.bind(("127.0.0.1", 0))
        never = ("127.0.0.1", spare.getsockname()[1])   # bound, not listening
        live = ("127.0.0.1", peer.getsockname()[1])
        names = {live: "live", never: "never"}
        mon.watch(*live)
        mon.watch(*never)
        out = [mon.poll_dead()]
        peer.close()
        out += [mon.poll_dead() for _ in range(3)]
        mon.rearm(*live)
        out.append(mon.poll_dead())
        mon.unwatch(*live)
        out.append(mon.poll_dead())
        mon.close()
        spare.close()
        return [sorted(names[a] for a in step) for step in out]

    got, want = trace(PeerMonitor), trace(ref_sup.PeerMonitor)
    assert got == want == [[], [], ["live"], [], [], []]
