"""Cluster worker process: one full engine over one key range.

Counterpart of ``siddhi_tpu/cluster/worker.py``. Runnable as ``python -m
siddhi_tpu_torch.cluster.worker --connect HOST:PORT --index I
--persist-dir DIR --device DEV``. The worker dials the router,
negotiates the wire hello (version and capability bits), then serves the
router's messages on one reader thread: DATA runs are processed strictly
in arrival order, which is what lets the router's egress merger rebuild
the exact global order from per-run completions.

Each deployed app gets its own ``SiddhiManager`` on ``--device`` (the
CUDA card unless the router asks for the CPU), a
``FileSystemPersistenceStore`` under the worker's directory and one sink
tap per egress stream. A device the process cannot open (``cuda`` with
no card visible) fails the deploy with an error naming it, which the
router raises from ``deploy``: a worker never carries on on another
device. On the card each worker opens its own CUDA context and loads the
kernels from ``siddhi_tpu_torch/_build/``.

State discipline: the worker holds NO replay log. The router records
every run it sends in a per-worker ``IngestWAL``
(``resilience/replay.py``), so a killed worker loses only what the router
can resend. On respawn the router re-deploys with ``restore=true`` (the
worker restores its last persisted revision from its own store) and
replays the WAL suffix as ordinary DATA runs; the egress merger drops the
re-emissions of already-merged tags. Liveness: the worker binds a
``PeerMonitor`` listener that the router's supervisor probes, and sends
in-band ``CTRL_HEARTBEAT`` frames on the link.

Beyond the reference's vocabulary, a worker answers ``MSG_STATS`` with
the device it runs on, the card's name and its kernel wrappers' launch
counts (``ClusterRuntime.worker_stats``).
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading


def _parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--connect", required=True, help="router HOST:PORT")
    ap.add_argument("--index", type=int, required=True)
    ap.add_argument("--persist-dir", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device every deployed app runs on")
    ap.add_argument("--hb-port", type=int, default=0,
                    help="PeerMonitor heartbeat listener port")
    ap.add_argument("--heartbeat-s", type=float, default=0.5)
    return ap.parse_args(argv)


class _AppHost:
    """One deployed app on this worker: manager, runtime and sink taps."""

    def __init__(self, name: str, text: str, sinks, store_dir: str, device: str,
                 config=None, restore: bool = False):
        from siddhi_tpu_torch.cluster.protocol import py_value
        from siddhi_tpu_torch.core.manager import SiddhiManager
        from siddhi_tpu_torch.core.stream.output.stream_callback import StreamCallback
        from siddhi_tpu_torch.core.util.config import InMemoryConfigManager
        from siddhi_tpu_torch.core.util.persistence import FileSystemPersistenceStore

        self.name = name
        self.emitted = []     # [(stream, ts, [values])] of the CURRENT run
        self.manager = SiddhiManager(device=device)
        os.makedirs(store_dir, exist_ok=True)
        self.manager.set_persistence_store(FileSystemPersistenceStore(store_dir))
        if config:
            self.manager.set_config_manager(InMemoryConfigManager(config))
        self.runtime = self.manager.create_siddhi_app_runtime(text)

        host = self

        class _Tap(StreamCallback):
            def __init__(self, stream):
                super().__init__()
                self._stream = stream

            def receive(self, events):
                host.emitted.extend(
                    (self._stream, int(e.timestamp), [py_value(v) for v in e.data])
                    for e in events)

        for s in sinks:
            self.runtime.add_callback(s, _Tap(s))
        self.runtime.start()
        self.restored_revision = None
        if restore:
            self.restored_revision = self.runtime.restore_last_revision()
        self.handlers = {}
        self.definitions = {
            sid: j.definition for sid, j in self.runtime.junctions.items()}

    def handler(self, stream: str):
        h = self.handlers.get(stream)
        if h is None:
            h = self.handlers[stream] = self.runtime.get_input_handler(stream)
        return h

    def take_emitted(self):
        out, self.emitted = self.emitted, []
        return out

    def shutdown(self):
        try:
            self.manager.shutdown()
        except Exception:   # noqa: BLE001 — exit path, best effort
            pass


def _device_info(device: str) -> dict:
    """The device a worker runs on and, on the card, the card's name (no
    CUDA context is opened for a device that is not cuda)."""
    import torch

    name = None
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        name = torch.cuda.get_device_name(dev)
    return {"device": str(dev), "device_name": name}


def _kernel_launches(reset: bool) -> dict:
    """The kernel wrappers' launch counts of this process (set to 0 after
    the read when ``reset``)."""
    from siddhi_tpu_torch.ops import _cuda
    from siddhi_tpu_torch.ops.distinct import distinct_scan
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    out = {"distinct_scan": int(distinct_scan.launches),
           "ring_exchange": int(ring_exchange.launches)}
    if reset:
        for wrapper in (distinct_scan, ring_exchange):
            _cuda.count(wrapper, "launches", -int(wrapper.launches))
    return out


def _serve(args) -> int:
    from siddhi_tpu_torch.cluster import protocol as P
    from siddhi_tpu_torch.core.stream.input.wire import (
        CAP_CONTROL, CAP_DICT_DELTA, CTRL_CHECKPOINT_CUT, CTRL_HEARTBEAT,
        CTRL_SEQ_ACK, DecoderRegistry, decode_control, decode_frame,
        encode_control, encode_hello, negotiate_hello)
    from siddhi_tpu_torch.resilience.supervisor import PeerMonitor

    host, port = args.connect.rsplit(":", 1)
    # the liveness listener the router's supervisor probes
    monitor = PeerMonitor(listen_port=args.hb_port)
    sock = socket.create_connection((host, int(port)), timeout=30)
    sock.settimeout(None)
    link = P.MessageSocket(sock)
    link.send(P.MSG_HELLO, encode_hello(
        sender_id=args.index,
        capabilities=CAP_CONTROL | CAP_DICT_DELTA | (1 << 0)))
    mtype, body = link.recv() or (None, b"")
    if mtype != P.MSG_HELLO:
        raise P.ProtocolError(f"router answered {mtype}, expected hello")
    negotiate_hello(body, required=CAP_CONTROL | CAP_DICT_DELTA)
    link.send(P.MSG_HELLO, encode_control(
        1, a=args.index, body=P.jdump({"index": args.index, "pid": os.getpid(),
                                       "hb_port": monitor.port,
                                       **_device_info(args.device)})))

    apps = {}
    registry = DecoderRegistry()
    stop = threading.Event()

    def _heartbeats():
        tick = 0
        while not stop.is_set():
            tick += 1
            try:
                link.send(P.MSG_HEARTBEAT, encode_control(
                    CTRL_HEARTBEAT, a=args.index, b=tick))
            except OSError:
                return              # router gone: the reader exits too
            stop.wait(args.heartbeat_s)

    threading.Thread(target=_heartbeats, daemon=True,
                     name="cluster-worker-heartbeat").start()

    while True:
        msg = link.recv()
        if msg is None:
            break                   # the router closed the link: exit
        mtype, body = msg
        if mtype == P.MSG_DEPLOY:
            spec = P.jload(body)
            name = spec["app"]
            try:
                old = apps.pop(name, None)
                if old is not None:
                    old.shutdown()
                apps[name] = _AppHost(
                    name, spec["text"], spec.get("sinks", ()),
                    os.path.join(args.persist_dir, name), args.device,
                    config=spec.get("config"), restore=bool(spec.get("restore")))
                link.send(P.MSG_DEPLOY_OK, P.jdump({
                    "app": name,
                    "revision": apps[name].restored_revision,
                    # the router partitions and decodes against these
                    "streams": {
                        sid: [[a.name, a.type.name] for a in d.attributes]
                        for sid, d in apps[name].definitions.items()}}))
            except Exception as e:      # noqa: BLE001 — reported, not fatal
                link.send(P.MSG_DEPLOY_OK, P.jdump({
                    "app": name, "error": f"{type(e).__name__}: {e}"}))
        elif mtype == P.MSG_DATA:
            seq, run, app_name, stream, frame = P.unpack_data(body)
            app = apps[app_name]
            data, ts = decode_frame(
                frame, app.definitions[stream],
                app.runtime.app_context.string_dictionary,
                registry, scope=app_name)
            app.handler(stream).send_columns(data, timestamps=ts)
            # the run's emissions in maximal same-stream slices (order kept:
            # the egress merger replays one tag's EMITs in arrival order)
            groups = []
            for out_stream, ets, values in app.take_emitted():
                if groups and groups[-1][0] == out_stream:
                    groups[-1][1].append([ets, values])
                else:
                    groups.append((out_stream, [[ets, values]]))
            for out_stream, rows in groups:
                link.send(P.MSG_EMIT, P.jdump({
                    "seq": seq, "run": run, "app": app_name,
                    "stream": out_stream, "rows": rows}))
            link.send(P.MSG_ACK, encode_control(CTRL_SEQ_ACK, a=run, b=seq))
        elif mtype == P.MSG_CHECKPOINT:
            cf = decode_control(body)
            revisions = {}
            for name, app in apps.items():
                revisions[name] = app.runtime.persist()
            link.send(P.MSG_CHECKPOINT_OK, encode_control(
                CTRL_CHECKPOINT_CUT, a=args.index, b=cf.b,
                body=P.jdump({"barrier": cf.b, "revisions": revisions})))
        elif mtype == P.MSG_QUERY:
            q = P.jload(body)
            try:
                events = apps[q["app"]].runtime.query(q["query"])
                rows = [[int(getattr(e, "timestamp", 0) or 0),
                         [P.py_value(v) for v in e.data]] for e in events]
                link.send(P.MSG_QUERY_RESULT, P.jdump({"qid": q["qid"], "rows": rows}))
            except Exception as e:      # noqa: BLE001 — reported, not fatal
                link.send(P.MSG_QUERY_RESULT, P.jdump({
                    "qid": q["qid"], "error": f"{type(e).__name__}: {e}"}))
        elif mtype == P.MSG_STATS:
            q = P.jload(body)
            link.send(P.MSG_STATS, P.jdump({
                "sid": q["sid"], "index": args.index, "pid": os.getpid(),
                **_device_info(args.device),
                "launches": _kernel_launches(bool(q.get("reset")))}))
        elif mtype == P.MSG_HEARTBEAT:
            pass                        # the router's pings are informational
        elif mtype == P.MSG_SHUTDOWN:
            break
        else:
            link.send(P.MSG_ERROR, P.jdump(
                {"context": "dispatch", "error": f"unknown message type {mtype}"}))
    stop.set()
    for app in apps.values():
        app.shutdown()
    monitor.close()
    link.close()
    return 0


def main(argv=None) -> int:
    def _die(tp, v, tb):
        # an uncaught failure must EXIT (and be seen), never park the
        # process half-dead with its heartbeat listener still up
        import traceback

        traceback.print_exception(tp, v, tb)
        sys.stderr.flush()
        os._exit(3)

    sys.excepthook = _die
    args = _parse_args(argv)
    try:
        return _serve(args)
    except (ConnectionError, OSError) as e:
        print(f"[cluster-worker {args.index}] link lost: {e}",
              file=sys.stderr, flush=True)
        return 0


if __name__ == "__main__":
    # os._exit: a half-dead link must never hang in atexit teardown
    os._exit(main())
