"""Cluster router: ingest sequencing, key partitioning, ordered egress.

Counterpart of ``siddhi_tpu/cluster/router.py``: the front-door process
of the fabric. One ``ClusterRuntime`` owns:

- an **ingest socket** accepting the columnar wire format (clients open
  with the wire hello; every frame is decoded with ``np.frombuffer``
  views against a router-side per-app ``StringDictionary`` and acked with
  a ``CTRL_SEQ_ACK`` carrying the assigned global sequence);
- the **global ingest sequence**: every accepted batch is stamped, then
  split into maximal contiguous same-owner row runs by ``crc32(key) %
  n_workers`` (``owner_of_key``, the reference's rule to the bit, so a
  key lands on the worker the reference would choose);
- one **worker link** per worker process: a ``RelayEncoder`` per (app,
  stream) keeps that link's dictionary-delta state, and a router-side
  per-worker ``IngestWAL`` (``resilience/replay.py``) records every run
  SENT, so a kill loses nothing the router cannot resend;
- the **ordered egress merger** (``egress.py``): emissions re-merge into
  exact global (seq, run) order;
- **checkpoint barriers**: quiesce (every outstanding run acked), send
  ``CTRL_CHECKPOINT_CUT`` to every worker, collect their persisted
  revisions, then cut and trim each worker's WAL;
- **recovery** (with ``cluster/supervisor.py``): a respawned worker is
  re-deployed with ``restore=true``, its WAL suffix replayed with the
  ORIGINAL tags, and its key range resumed; the egress merger's
  completed-tag set absorbs the duplicate emissions.

Split vs pinned deployment: an app whose every input stream has a
declared partition key is SPLIT row-wise across all workers (exact for
the key-local query class: partitioned queries, aggregations grouped by
the partition key); an app with no partition keys is PINNED whole to
``crc32(app_name) % n`` (exact for ANY app).

The workers run on ``device`` (the CUDA card unless the caller asks for
the CPU; each worker process opens its own CUDA context on it). The
router itself runs no engine: it decodes, splits, relays and merges on
the host. ``worker_stats`` asks every live worker for its device, the
card's name and its kernel wrappers' launch counts.
"""

from __future__ import annotations

import re
import socket
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.analysis.guards import guarded
from siddhi_tpu_torch.analysis.locks import make_lock
from siddhi_tpu_torch.cluster import protocol as P
from siddhi_tpu_torch.cluster.egress import OrderedEgress
from siddhi_tpu_torch.cluster.protocol import RelayEncoder, encode_for_link
from siddhi_tpu_torch.core.event import StringDictionary
from siddhi_tpu_torch.core.stream.input.wire import (
    CAP_CONTROL, CAP_DICT_DELTA, CTRL_CHECKPOINT_CUT, CTRL_SEQ_ACK,
    DecoderRegistry, WireEncoder, decode_control, decode_frame,
    encode_control, encode_hello, negotiate_hello)
from siddhi_tpu_torch.query_api.definitions import (
    Attribute, AttrType, StreamDefinition)
from siddhi_tpu_torch.resilience.replay import IngestWAL

_APP_NAME = re.compile(r"@app:name\(\s*['\"]([^'\"]+)['\"]\s*\)")


def _count(name: str, n: int = 1) -> None:
    from siddhi_tpu_torch.observability.telemetry import global_registry

    global_registry().count(name, n)


def owner_of_key(value, n_workers: int) -> int:
    """The fabric's owner-by-modulus convention: ``crc32(key) % n``."""
    return zlib.crc32(str(value).encode("utf-8")) % n_workers


@guarded
class _WorkerLink:
    """Router-side state of one worker process' link."""

    # `up`/`acked_seq`/`last_heartbeat` stay undeclared: they are
    # lock-free liveness probes read by gauges and status snapshots
    GUARDED_BY = {"encoders": "link", "tags": "link"}

    def __init__(self, idx: int, wal_batches: int):
        self.idx = idx
        self.sock: Optional[P.MessageSocket] = None
        self.up = False
        self.ready = threading.Event()       # cleared while down/recovering
        self._lock = make_lock("link")       # serializes send vs recovery
        self.wal = IngestWAL(max_batches=wal_batches)
        self.tags: Dict[int, Tuple[Tuple[int, int], str, str]] = {}
        self.encoders: Dict[Tuple[str, str], RelayEncoder] = {}
        self.apps = set()
        self.deploy_waits: Dict[str, tuple] = {}   # app -> (Event, box)
        self.barrier_waits: Dict[int, tuple] = {}  # barrier -> (Event, box)
        self.last_heartbeat = 0.0
        self.acked_seq = 0
        self.sent_runs = 0
        self.pid: Optional[int] = None
        self.hb_port: Optional[int] = None
        self.device: Optional[str] = None         # from the worker's hello
        self.device_name: Optional[str] = None

    def trim_tags(self, cut: int) -> None:
        """Drop WAL-tag entries a checkpoint cut has covered."""
        with self._lock:
            self.tags = {s: t for s, t in self.tags.items() if s > cut}

    def invalidate_session_locked(self) -> None:
        """Caller holds this link's lock (rank ``link``)."""
        self.up = False
        self.ready.clear()
        self.encoders = {}
        # a deploy/barrier waiter must not hang on a dead link
        for ev, box in list(self.deploy_waits.values()):
            box.setdefault("error", "worker link lost")
            ev.set()
        for ev, box in list(self.barrier_waits.values()):
            box.setdefault("error", "worker link lost")
            ev.set()


class _AppSpec:
    """One deployed app as the router sees it."""

    def __init__(self, name: str, text: str, sinks: List[str],
                 partition_keys: Optional[Dict[str, str]],
                 config: Optional[dict], n_workers: int):
        self.name = name
        self.text = text
        self.sinks = list(sinks)
        self.partition_keys = dict(partition_keys or {})
        self.config = dict(config) if config else None
        self.mode = "split" if self.partition_keys else "pinned"
        self.home = owner_of_key(name, n_workers)
        self.workers = (list(range(n_workers)) if self.mode == "split"
                        else [self.home])
        self.dictionary = StringDictionary()
        self.definitions: Dict[str, StreamDefinition] = {}
        self.string_attrs: Dict[str, frozenset] = {}
        # partition attr per stream: (attr_name, is_string)
        self.part_attr: Dict[str, Tuple[str, bool]] = {}
        # router-id -> owner cache (string keys) / value -> owner cache
        self.owner_lut = np.full(0, -1, np.int64)
        self.owner_cache: Dict[object, int] = {}
        self.encoder = WireEncoder()     # in-process loopback framing

    def learn_definitions(self, streams: Dict[str, list]) -> None:
        for sid, attrs in streams.items():
            if sid in self.definitions:
                continue
            d = StreamDefinition(sid, attributes=[
                Attribute(n, AttrType[t]) for n, t in attrs])
            self.definitions[sid] = d
            self.string_attrs[sid] = frozenset(
                a.name for a in d.attributes
                if a.type == AttrType.STRING)
        for sid, key in self.partition_keys.items():
            d = self.definitions.get(sid)
            if d is None:
                raise ValueError(
                    f"partition key declared for unknown stream "
                    f"'{sid}' of app '{self.name}'")
            kinds = {a.name: a.type for a in d.attributes}
            if key not in kinds:
                raise ValueError(
                    f"partition key '{key}' is not an attribute of "
                    f"stream '{sid}'")
            self.part_attr[sid] = (key, kinds[key] == AttrType.STRING)


@guarded
class ClusterRuntime:
    """The router process' in-process handle on the whole fabric."""

    GUARDED_BY = {
        "_seq": "cluster_ingest", "_barrier_id": "cluster_ingest",
        "_conn_seq": "router", "_qid": "router",
        "_query_waits": "router", "_stats_waits": "router", "apps": "router",
    }

    def __init__(self, n_workers: Optional[int] = None,
                 config: Optional[dict] = None,
                 persist_root: Optional[str] = None,
                 heartbeat_s: Optional[float] = None,
                 checkpoint_s: Optional[float] = None,
                 wal_batches: Optional[int] = None,
                 spawn: bool = True, device=None):
        from siddhi_tpu_torch.core.util.config import InMemoryConfigManager
        from siddhi_tpu_torch.core.util.knobs import read_knob

        cm = InMemoryConfigManager(config) if config else None
        # the workers' device: the card unless the caller asks otherwise
        # (a worker that cannot open it fails its deploy naming it)
        self.device = str(device) if device is not None else "cuda"
        self.n_workers = int(
            n_workers if n_workers is not None
            else (read_knob(cm, "cluster_workers") or 2))
        if self.n_workers < 1:
            raise ValueError("ClusterRuntime needs n_workers >= 1")
        self.heartbeat_s = float(
            heartbeat_s if heartbeat_s is not None
            else (read_knob(cm, "cluster_heartbeat_s") or 0.5))
        self.checkpoint_s = float(
            checkpoint_s if checkpoint_s is not None
            else (read_knob(cm, "cluster_checkpoint_s") or 0.0))
        self._wal_batches = int(
            wal_batches if wal_batches is not None
            else (read_knob(cm, "cluster_wal_batches") or 4096))

        self.egress = OrderedEgress()
        self.apps: Dict[str, _AppSpec] = {}
        self.links = [_WorkerLink(i, self._wal_batches)
                      for i in range(self.n_workers)]
        self._ingest_lock = make_lock("cluster_ingest")  # global sequencing
        self._seq = 0
        self._barrier_id = 0
        self._qid = 0
        self._query_waits: Dict[int, tuple] = {}
        self._stats_waits: Dict[int, tuple] = {}
        self._closing = False
        self._lock = make_lock("router")

        # worker-link listener
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        threading.Thread(target=self._accept_workers, daemon=True,
                         name="cluster-router-accept").start()

        # ingest front door (wire frames from external clients)
        self._ingest_sock = socket.socket(socket.AF_INET,
                                          socket.SOCK_STREAM)
        self._ingest_sock.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEADDR, 1)
        self._ingest_sock.bind(("127.0.0.1", 0))
        self._ingest_sock.listen(64)
        self.ingest_port = self._ingest_sock.getsockname()[1]
        self._ingest_registry = DecoderRegistry()
        self._conn_seq = 0
        threading.Thread(target=self._accept_ingest, daemon=True,
                         name="cluster-router-ingest").start()

        self._register_gauges()

        self.supervisor = None
        if spawn:
            from siddhi_tpu_torch.cluster.supervisor import WorkerSupervisor

            self.supervisor = WorkerSupervisor(
                self, persist_root=persist_root,
                heartbeat_s=self.heartbeat_s)
            self.supervisor.start()
        if self.checkpoint_s > 0:
            threading.Thread(target=self._auto_checkpoint, daemon=True,
                             name="cluster-router-checkpoint").start()

    # ------------------------------------------------------------ telemetry

    def _register_gauges(self) -> None:
        from siddhi_tpu_torch.observability.telemetry import global_registry

        g = global_registry()
        g.gauge("cluster.workers.live",
                lambda: sum(1 for li in self.links if li.up))
        for link in self.links:
            g.gauge(f"cluster.worker.acked_seq.{link.idx}",
                    lambda li=link: li.acked_seq)
            g.gauge(f"cluster.worker.wal_batches.{link.idx}",
                    lambda li=link: len(li.wal))

    def _remove_gauges(self) -> None:
        from siddhi_tpu_torch.observability.telemetry import global_registry

        g = global_registry()
        g.remove_gauge("cluster.workers.live")
        for link in self.links:
            g.remove_gauge(f"cluster.worker.acked_seq.{link.idx}")
            g.remove_gauge(f"cluster.worker.wal_batches.{link.idx}")

    # ------------------------------------------------------- worker links

    def _accept_workers(self) -> None:
        while not self._closing:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._attach_worker, args=(conn,),
                             daemon=True,
                             name="cluster-router-attach").start()

    def _attach_worker(self, conn: socket.socket) -> None:
        try:
            msock = P.MessageSocket(conn)
            mtype, body = msock.recv() or (None, b"")
            if mtype != P.MSG_HELLO:
                msock.close()
                return
            negotiate_hello(body, required=CAP_CONTROL | CAP_DICT_DELTA)
            msock.send(P.MSG_HELLO, encode_hello())
            mtype, body = msock.recv() or (None, b"")
            if mtype != P.MSG_HELLO:
                msock.close()
                return
            info = P.jload(decode_control(body).body)
            idx = int(info["index"])
            link = self.links[idx]
        except (P.ProtocolError, OSError, ValueError, KeyError,
                IndexError) as e:
            print(f"[cluster-router] rejected worker link: {e}",
                  flush=True)
            try:
                conn.close()
            except OSError:
                pass
            return
        with self._lock:
            link.sock = msock
            link.pid = info.get("pid")
            link.hb_port = info.get("hb_port")
            link.device = info.get("device")
            link.device_name = info.get("device_name")
            link.last_heartbeat = time.monotonic()
            reconnect = bool(link.apps)
            # on reconnect `up` stays false until recovery has replayed
            # the WAL suffix (under the session lock) — a fresh send must
            # never overtake the replay
            link.up = not reconnect
        threading.Thread(target=self._reader, args=(link, msock),
                         daemon=True,
                         name=f"cluster-router-reader-{link.idx}").start()
        if reconnect:
            threading.Thread(target=self._recover_worker, args=(link,),
                             daemon=True,
                             name=f"cluster-recover-{link.idx}").start()
        else:
            link.ready.set()
        if self.supervisor is not None:
            self.supervisor.worker_attached(link.idx)

    def _reader(self, link: _WorkerLink, msock: P.MessageSocket) -> None:
        while True:
            try:
                msg = msock.recv()
            except P.ProtocolError:
                msg = None
            if msg is None:
                break
            mtype, body = msg
            if mtype == P.MSG_EMIT:
                e = P.jload(body)
                tag = (int(e["seq"]), int(e["run"]))
                rows = [(int(ts), vals) for ts, vals in e["rows"]]
                if self.egress.emit(tag, e["app"], e["stream"], rows):
                    _count("cluster.egress_rows", len(rows))
                else:
                    _count("cluster.duplicate_emits_dropped")
            elif mtype == P.MSG_ACK:
                cf = decode_control(body)
                tag = (cf.b, cf.a)
                link.acked_seq = max(link.acked_seq, cf.b)
                if self.egress.complete(tag):
                    _count("cluster.runs_acked")
            elif mtype == P.MSG_CHECKPOINT_OK:
                cf = decode_control(body)
                waiter = link.barrier_waits.get(cf.b)
                if waiter is not None:
                    ev, box = waiter
                    box.update(P.jload(cf.body))
                    ev.set()
            elif mtype == P.MSG_DEPLOY_OK:
                ok = P.jload(body)
                waiter = link.deploy_waits.get(ok.get("app"))
                if waiter is not None:
                    ev, box = waiter
                    box.update(ok)
                    ev.set()
            elif mtype == P.MSG_QUERY_RESULT:
                r = P.jload(body)
                with self._lock:
                    waiter = self._query_waits.get(r.get("qid"))
                if waiter is not None:
                    ev, box, pending = waiter
                    box[link.idx] = r
                    pending.discard(link.idx)
                    if not pending:
                        ev.set()
            elif mtype == P.MSG_STATS:
                r = P.jload(body)
                with self._lock:
                    waiter = self._stats_waits.get(r.get("sid"))
                if waiter is not None:
                    ev, box, pending = waiter
                    box[link.idx] = r
                    pending.discard(link.idx)
                    if not pending:
                        ev.set()
            elif mtype == P.MSG_HEARTBEAT:
                link.last_heartbeat = time.monotonic()
            elif mtype == P.MSG_ERROR:
                print(f"[cluster-router] worker {link.idx} error: "
                      f"{P.jload(body)}", flush=True)
        with link._lock:
            with self._lock:
                if link.sock is msock and not self._closing:
                    link.invalidate_session_locked()
                    _count(f"cluster.worker.link_drops.{link.idx}")
                    if self.supervisor is not None:
                        self.supervisor.worker_lost(link.idx)

    # ---------------------------------------------------------- deployment

    def deploy(self, text: str, name: Optional[str] = None,
               partition_keys: Optional[Dict[str, str]] = None,
               sinks: Optional[List[str]] = None,
               config: Optional[dict] = None,
               timeout: float = 60.0) -> _AppSpec:
        """Deploy one SiddhiQL app on the fabric. ``partition_keys``
        ({input stream: key attribute}) selects SPLIT mode; without it
        the whole app is PINNED to one worker. ``sinks`` lists the
        output streams whose emissions flow back through the ordered
        egress."""
        if name is None:
            m = _APP_NAME.search(text)
            if m is None:
                raise ValueError("deploy needs name= (or an @app:name "
                                 "annotation in the app text)")
            name = m.group(1)
        with self._lock:
            if name in self.apps:
                raise ValueError(f"app '{name}' is already deployed")
        app = _AppSpec(name, text, sinks or [], partition_keys, config,
                       self.n_workers)
        for idx in app.workers:
            if not self.links[idx].ready.wait(timeout):
                raise TimeoutError(f"worker {idx} never came up")
        first_box = None
        for idx in app.workers:
            box = self._deploy_on(self.links[idx], app, restore=False,
                                  timeout=timeout)
            if first_box is None:
                first_box = box
        app.learn_definitions(first_box.get("streams", {}))
        with self._lock:
            self.apps[name] = app
        return app

    def _deploy_on(self, link: _WorkerLink, app: _AppSpec,
                   restore: bool, timeout: float) -> dict:
        ev, box = threading.Event(), {}
        link.deploy_waits[app.name] = (ev, box)
        try:
            link.sock.send(P.MSG_DEPLOY, P.jdump({
                "app": app.name, "text": app.text, "sinks": app.sinks,
                "config": app.config, "restore": restore}))
            if not ev.wait(timeout):
                raise TimeoutError(
                    f"worker {link.idx} did not ack deploy of "
                    f"'{app.name}'")
        finally:
            link.deploy_waits.pop(app.name, None)
        if box.get("error"):
            raise RuntimeError(
                f"worker {link.idx} failed to deploy '{app.name}': "
                f"{box['error']}")
        link.apps.add(app.name)
        return box

    # -------------------------------------------------------------- ingest

    def send_columns(self, app_name: str, stream: str,
                     data: Dict[str, np.ndarray], timestamps=None) -> int:
        """In-process ingest: frames through the app's loopback encoder
        so BOTH ingest paths (socket and in-process) share one decode +
        split + relay pipeline. Returns the assigned global sequence."""
        with self._lock:
            app = self.apps[app_name]
        frame = app.encoder.encode(
            dict(data), timestamps=timestamps)
        return self._ingest_frame(app, stream, frame,
                                  scope=(app_name, "@local"))

    def _ingest_frame(self, app: _AppSpec, stream: str, frame: bytes,
                      scope) -> int:
        d = app.definitions.get(stream)
        if d is None:
            raise KeyError(f"app '{app.name}' has no stream '{stream}'")
        data, ts = decode_frame(frame, d, app.dictionary,
                                self._ingest_registry, scope=scope)
        n_rows = 0
        for v in data.values():
            n_rows = len(v)
            break
        with self._ingest_lock:
            self._seq += 1
            seq = self._seq
            _count("cluster.ingest_batches")
            _count("cluster.ingest_rows", n_rows)
            for run, (widx, rdata, rts) in enumerate(
                    self._split_runs(app, stream, data, ts)):
                tag = (seq, run)
                self.egress.expect(tag)
                self._send_run(self.links[widx], tag, app, stream,
                               rdata, rts)
        return seq

    def _split_runs(self, app: _AppSpec, stream: str, data, ts):
        """Maximal contiguous same-owner row runs, in row order."""
        if app.mode == "pinned" or not data:
            yield app.home, data, ts
            return
        part = app.part_attr.get(stream)
        if part is None:
            raise ValueError(
                f"split app '{app.name}' has no partition key for "
                f"stream '{stream}' — declare it in partition_keys")
        owners = self._owners_of(app, data[part[0]], part[1])
        if len(owners) == 0:
            yield app.home, data, ts
            return
        cuts = np.flatnonzero(np.diff(owners)) + 1
        bounds = np.concatenate(([0], cuts, [len(owners)]))
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            lo, hi = int(lo), int(hi)
            rdata = {k: v[lo:hi] for k, v in data.items()}
            rts = ts[lo:hi] if ts is not None else None
            yield int(owners[lo]), rdata, rts

    def _owners_of(self, app: _AppSpec, col, is_string: bool):
        col = np.asarray(col)
        if is_string:
            ids = col.astype(np.int64)
            hi = int(ids.max(initial=-1))
            if hi >= len(app.owner_lut):
                grown = np.full(hi + 1, -1, np.int64)
                grown[:len(app.owner_lut)] = app.owner_lut
                app.owner_lut = grown
            valid = ids >= 0
            safe = np.where(valid, ids, 0)
            for rid in np.unique(safe[valid & (app.owner_lut[safe] < 0)]
                                 ) if valid.any() else ():
                app.owner_lut[int(rid)] = owner_of_key(
                    app.dictionary.decode(int(rid)), self.n_workers)
            return np.where(valid, app.owner_lut[safe], 0)
        owners = np.empty(len(col), np.int64)
        cache = app.owner_cache
        for i, v in enumerate(col):
            key = v.item() if isinstance(v, np.generic) else v
            o = cache.get(key)
            if o is None:
                o = cache[key] = owner_of_key(key, self.n_workers)
            owners[i] = o
        return owners

    def _send_run(self, link: _WorkerLink, tag, app: _AppSpec,
                  stream: str, data, ts, record: bool = True) -> None:
        # the WAL record and its tag must land under the link lock:
        # recovery iterates `link.tags` under the same lock, and an
        # ingest racing a replay must not mutate the dict mid-iteration
        with link._lock:
            if record:
                wal_seq = link.wal.record_columns(stream, data,
                                                  timestamps=ts)
                link.tags[wal_seq] = (tag, app.name, stream)
            if not link.up:
                return          # down: the WAL replay will deliver it
            try:
                self._relay(link, tag, app, stream, data, ts)
            except OSError:
                with self._lock:
                    if not self._closing:
                        link.invalidate_session_locked()
                        if self.supervisor is not None:
                            self.supervisor.worker_lost(link.idx)

    def _relay(self, link: _WorkerLink, tag, app: _AppSpec, stream: str,
               data, ts) -> None:
        enc = link.encoders.get((app.name, stream))
        if enc is None:
            enc = link.encoders[(app.name, stream)] = \
                RelayEncoder(app.dictionary)
        frame = encode_for_link(enc, data, app.string_attrs[stream],
                                timestamps=ts)
        link.sock.send(P.MSG_DATA, P.pack_data(
            tag[0], tag[1], app.name, stream, frame))
        link.sent_runs += 1
        _count("cluster.runs_sent")

    # ------------------------------------------------------ ingest socket

    def _accept_ingest(self) -> None:
        while not self._closing:
            try:
                conn, _addr = self._ingest_sock.accept()
            except OSError:
                return
            with self._lock:
                self._conn_seq += 1
                cid = self._conn_seq
            threading.Thread(target=self._serve_ingest,
                             args=(conn, cid), daemon=True,
                             name=f"cluster-ingest-conn-{cid}").start()

    def _serve_ingest(self, conn: socket.socket, cid: int) -> None:
        msock = P.MessageSocket(conn)
        try:
            mtype, body = msock.recv() or (None, b"")
            if mtype != P.MSG_HELLO:
                raise P.ProtocolError("ingest link must open with hello")
            negotiate_hello(body, required=CAP_DICT_DELTA)
            msock.send(P.MSG_HELLO, encode_hello())
            while True:
                msg = msock.recv()
                if msg is None:
                    return
                mtype, body = msg
                if mtype != P.MSG_INGEST:
                    raise P.ProtocolError(
                        f"unexpected message {mtype} on ingest link")
                _s, _r, app_name, stream, frame = P.unpack_data(body)
                with self._lock:
                    app = self.apps.get(app_name)
                if app is None:
                    raise P.ProtocolError(f"unknown app '{app_name}'")
                seq = self._ingest_frame(app, stream, frame,
                                         scope=(app_name, cid))
                msock.send(P.MSG_INGEST_ACK,
                           encode_control(CTRL_SEQ_ACK, b=seq))
        except Exception as e:     # noqa: BLE001 — per-connection scope
            if not self._closing:
                try:
                    msock.send(P.MSG_ERROR, P.jdump(
                        {"context": "ingest", "error": str(e)}))
                except OSError:
                    pass
        finally:
            msock.close()

    # --------------------------------------------------------- checkpoints

    def checkpoint(self, timeout: float = 120.0) -> Dict[int, dict]:
        """One cluster checkpoint barrier: quiesce, cut every worker, trim
        every WAL at its cut. Returns {worker: revisions}."""
        with self._ingest_lock:
            if not self.egress.wait_quiesced(timeout):
                raise TimeoutError(
                    f"checkpoint barrier: "
                    f"{self.egress.outstanding()} runs still outstanding")
            self._barrier_id += 1
            barrier = self._barrier_id
            cuts, waiters, out = {}, {}, {}
            live = [li for li in self.links if li.apps]
            for link in live:
                if not link.ready.wait(timeout):
                    raise TimeoutError(
                        f"checkpoint barrier: worker {link.idx} not up")
                cuts[link.idx] = link.wal.cut()
                ev, box = threading.Event(), {}
                link.barrier_waits[barrier] = (ev, box)
                waiters[link.idx] = (ev, box)
                link.sock.send(P.MSG_CHECKPOINT, encode_control(
                    CTRL_CHECKPOINT_CUT, b=barrier))
            try:
                for link in live:
                    ev, box = waiters[link.idx]
                    if not ev.wait(timeout):
                        raise TimeoutError(
                            f"checkpoint barrier {barrier}: worker "
                            f"{link.idx} never cut")
                    if box.get("error"):
                        raise RuntimeError(
                            f"checkpoint barrier {barrier}: worker "
                            f"{link.idx}: {box['error']}")
            finally:
                for link in live:
                    link.barrier_waits.pop(barrier, None)
            for link in live:
                cut = cuts[link.idx]
                link.wal.trim(cut)
                revs = waiters[link.idx][1].get("revisions", {})
                link.wal.checkpoint_revision = \
                    next(iter(revs.values()), None)
                link.trim_tags(cut)
                out[link.idx] = revs
            _count("cluster.checkpoints")
            return out

    def _auto_checkpoint(self) -> None:
        while not self._closing:
            time.sleep(self.checkpoint_s)
            if self._closing:
                return
            try:
                self.checkpoint()
            except Exception as e:   # noqa: BLE001 — periodic, retried
                print(f"[cluster-router] auto-checkpoint failed: {e}",
                      flush=True)

    # ------------------------------------------------------------ recovery

    def _recover_worker(self, link: _WorkerLink) -> None:
        """Router-driven recovery: re-deploy with restore, replay the WAL
        suffix with ORIGINAL tags, resume the key range."""
        _count(f"cluster.worker.respawns.{link.idx}")
        with link._lock:
            with self._lock:
                apps = dict(self.apps)
            try:
                for app_name in sorted(link.apps):
                    self._deploy_on(link, apps[app_name],
                                    restore=True, timeout=120.0)
                records = link.wal.records_after(0)
                retained = {rec.seq for rec in records}
                # runs the bounded WAL lost to overflow can never
                # complete: surface the gap, release the merge head
                for wal_seq in sorted(link.tags):
                    if wal_seq not in retained:
                        tag, _a, _s = link.tags.pop(wal_seq)
                        self.egress.forget(tag)
                        _count(f"cluster.worker.replay_gaps.{link.idx}")
                # rows the dead incarnation emitted for tags it never
                # acked are about to be regenerated — drop the stale
                # copies BEFORE any re-send
                for rec in records:
                    self.egress.drop_pending(link.tags[rec.seq][0])
                for rec in records:
                    tag, app_name, stream = link.tags[rec.seq]
                    self._relay(link, tag, apps[app_name],
                                rec.stream_id, rec.payload,
                                rec.timestamps)
                    _count(f"cluster.worker.replayed_batches.{link.idx}")
                link.up = True
                link.ready.set()
            except Exception as e:   # noqa: BLE001 — supervisor retries
                print(f"[cluster-router] recovery of worker {link.idx} "
                      f"failed: {e}", flush=True)
                with self._lock:
                    link.invalidate_session_locked()
                    if self.supervisor is not None:
                        self.supervisor.worker_lost(link.idx)

    # --------------------------------------------------------------- query

    def query(self, app_name: str, query_text: str,
              timeout: float = 60.0) -> List[list]:
        """On-demand query, scatter-gathered: a PINNED app answers from
        its one owner; a SPLIT app fans out to every worker and the parts
        re-merge with the deterministic stitch
        (``serving/cluster_gather.py``)."""
        from siddhi_tpu_torch.serving.cluster_gather import gather_query_rows

        with self._lock:
            app = self.apps[app_name]
            self._qid += 1
            qid = self._qid
            targets = [self.links[i] for i in app.workers]
            ev, box, pending = (threading.Event(), {},
                                {li.idx for li in targets})
            self._query_waits[qid] = (ev, box, pending)
        try:
            for link in targets:
                if not link.ready.wait(timeout):
                    raise TimeoutError(f"worker {link.idx} not up")
                link.sock.send(P.MSG_QUERY, P.jdump(
                    {"qid": qid, "app": app_name, "query": query_text}))
            if not ev.wait(timeout):
                raise TimeoutError(
                    f"query fan-out: workers "
                    f"{sorted(pending)} never answered")
        finally:
            with self._lock:
                self._query_waits.pop(qid, None)
        parts = []
        for idx in sorted(box):
            r = box[idx]
            if r.get("error"):
                raise RuntimeError(
                    f"worker {idx} query failed: {r['error']}")
            parts.append(r.get("rows", []))
        _count("cluster.queries")
        return gather_query_rows(parts)

    def worker_stats(self, reset: bool = False, timeout: float = 60.0) -> Dict[int, dict]:
        """{worker: {"device", "device_name", "pid", "launches"}} from every
        worker: the device it runs on, the card's name (None off the card)
        and its kernel wrappers' launch counts, each set to 0 after the
        read when ``reset``."""
        with self._lock:
            self._qid += 1
            sid = self._qid
            ev, box, pending = (threading.Event(), {},
                                {li.idx for li in self.links})
            self._stats_waits[sid] = (ev, box, pending)
        try:
            for link in self.links:
                if not link.ready.wait(timeout):
                    raise TimeoutError(f"worker {link.idx} not up")
                link.sock.send(P.MSG_STATS, P.jdump({"sid": sid, "reset": reset}))
            if not ev.wait(timeout):
                raise TimeoutError(
                    f"worker stats: workers {sorted(pending)} never answered")
        finally:
            with self._lock:
                self._stats_waits.pop(sid, None)
        return {idx: box[idx] for idx in sorted(box)}

    def status(self) -> dict:
        """JSON-ready fabric status (the REST tier's GET /cluster)."""
        with self._lock:
            app_items = sorted(self.apps.items())
        eg = self.egress.counters()
        eg["outstanding"] = self.egress.outstanding()
        return {
            "workers": self.n_workers,
            "device": self.device,
            "live": sum(1 for li in self.links if li.up),
            "ingest_port": self.ingest_port,
            "apps": {name: {"mode": spec.mode,
                            "workers": sorted(spec.workers),
                            "sinks": list(spec.sinks)}
                     for name, spec in app_items},
            "per_worker": {
                li.idx: {"up": li.up,
                         "acked_seq": li.acked_seq,
                         "wal_batches": len(li.wal),
                         "pid": li.pid,
                         "device": li.device,
                         "device_name": li.device_name,
                         "respawns": (self.supervisor.respawn_count(li.idx)
                                      if self.supervisor else 0)}
                for li in self.links},
            "egress": eg,
        }

    # ------------------------------------------------------------ teardown

    def wait_ready(self, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        for link in self.links:
            if not link.ready.wait(max(0.0, deadline - time.monotonic())):
                raise TimeoutError(f"worker {link.idx} never came up")

    def quiesce(self, timeout: float = 120.0) -> bool:
        return self.egress.wait_quiesced(timeout)

    def shutdown(self) -> None:
        self._closing = True
        if self.supervisor is not None:
            self.supervisor.stop()
        for link in self.links:
            if link.sock is not None:
                try:
                    link.sock.send(P.MSG_SHUTDOWN)
                except OSError:
                    pass
                link.sock.close()
        for s in (self._sock, self._ingest_sock):
            try:
                s.close()
            except OSError:
                pass
        self._remove_gauges()
