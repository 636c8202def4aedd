"""REST service: HTTP surface over SiddhiManager.

Counterpart of ``siddhi_tpu/service/rest.py`` (the reference runner's
HTTP APIs: deploy apps, inject events, run on-demand queries, snapshot
state, read metrics) on the standard-library HTTP server — no framework
dependency, one daemon thread, port 0 (any free port) by default.

Endpoints (JSON in/out):

- ``GET  /apps``                       — deployed app names
- ``POST /apps``                       — body = SiddhiQL app text (deploy + start)
- ``DELETE /apps/<name>``              — shutdown + undeploy
- ``POST /apps/<name>/events``         — ``{"stream": S, "data": [...] | [[...], ...], "timestamp": optional}``
- ``POST /query``                      — ``{"app": name, "query": "<on-demand query>"}`` -> rows;
  runs on a bounded executor with a per-endpoint queue cap
  (``serving/query_tier.py``) — past the cap the request is shed with
  ``503`` + ``Retry-After`` instead of queuing behind the app barrier
- ``GET  /apps/<name>/statistics``     — metrics snapshot
- ``POST /apps/<name>/persist``        — checkpoint; -> ``{"revision": ...}``
- ``POST /apps/<name>/restore``        — ``{"revision": optional}`` (last when omitted)
- ``POST /ingest/<stream>[?app=name]`` — body = one binary columnar wire
  frame (``core/stream/input/wire.py``), admission-fronted (503 +
  Retry-After past the cap), malformed frames answer 400 naming the
  defect; landed through ``InputHandler.send_columns`` so the WAL and
  ``@app:enforceOrder`` apply
- ``GET  /programs``                   — the step-program cost registry
  (``observability/costmodel.py``: records and fingerprint clusters) plus
  ``"cache"``, the process-global program cache
  (``core/util/program_cache.py``: entries, sharers, refcounts, graphs)
- ``POST /profile/costs/start|stop``   — program cost capture on/off
- ``GET  /metrics[/<name>]``           — Prometheus text exposition
  (``observability/export.py``); ``?format=json`` or ``Accept:
  application/json`` returns the JSON snapshot

The reference's routes over modules the port lacks answer ``501`` naming
their ROADMAP item: the span tracer (``/trace/start|stop``), the device
profiler trace (``/apps/<name>/trace``; its body is validated first, as
the reference validates it), the critical-path profiler
(``/profile/critical_path``, ``/profile/journeys/*``,
``/profile/device/*``), the autopilot
(``/autopilot``) and the cluster fabric (``/cluster``; the ``cluster=``
argument raises). Without the overload layer's per-app query quotas
(ROADMAP A.10) every app uses the endpoint's cap, as the reference does
when no quota is registered.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

# unported routes: first path segment -> what they need and where it waits
_UNPORTED = {
    "trace": "the span tracer (observability/tracing.py) is ROADMAP A.10",
    "profile": ("the critical-path profiler (observability/journey.py) and "
                "the device profiler trace are ROADMAP A.10"),
    "autopilot": "the autopilot (siddhi_tpu/autopilot/) is ROADMAP A.10",
    "cluster": "the cluster fabric (siddhi_tpu/cluster/) is ROADMAP A.10",
}
_APP_TRACE = ("the device profiler trace (SiddhiAppRuntime.start_trace) "
              "is ROADMAP A.10")


class SiddhiRestService:
    def __init__(self, manager, host: str = "127.0.0.1", port: int = 0,
                 trace_base: Optional[str] = None,
                 query_workers: int = 8, query_queue_cap: int = 64,
                 cluster=None):
        if cluster is not None:
            raise NotImplementedError(
                "SiddhiRestService(cluster=...): " + _UNPORTED["cluster"])
        self.manager = manager
        # trace directories are confined under this directory; clients
        # supply a relative name, never an absolute filesystem path
        self.trace_base = trace_base or os.path.join(
            tempfile.gettempdir(), "siddhi_tpu_traces")
        from siddhi_tpu_torch.serving.query_tier import AdmissionPool

        self.admission = AdmissionPool(max_workers=query_workers,
                                       default_cap=query_queue_cap)
        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):   # quiet
                pass

            def _send(self, code: int, obj):
                body = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_text(self, code: int, text: str,
                           ctype: str = "text/plain; version=0.0.4; "
                                        "charset=utf-8"):
                body = text.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_shed(self, e):
                """503 + Retry-After for admission sheds (/query and
                /ingest share the policy)."""
                self.send_response(503)
                self.send_header("Retry-After", "1")
                payload = json.dumps(
                    {"error": str(e), "shed": True}).encode("utf-8")
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _send_unported(self, what: str):
                self._send(501, {"error": f"{self.path}: {what}"})

            def _body(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b""
                ctype = self.headers.get("Content-Type", "")
                if "json" in ctype and raw:
                    return json.loads(raw)
                return raw.decode("utf-8")

            def do_GET(self):
                try:
                    service._get(self)
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"error": str(e)})

            def do_POST(self):
                try:
                    service._post(self)
                except Exception as e:  # noqa: BLE001
                    self._send(400, {"error": str(e)})

            def do_DELETE(self):
                try:
                    service._delete(self)
                except Exception as e:  # noqa: BLE001
                    self._send(400, {"error": str(e)})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None
        # per-encoder dictionary-delta state for POST /ingest/{stream}
        from siddhi_tpu_torch.core.stream.input.wire import DecoderRegistry

        self._wire_decoders = DecoderRegistry()

    # ----------------------------------------------------------- lifecycle

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="siddhi-rest")
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.admission.shutdown()

    # ------------------------------------------------------------ handlers

    def _rt(self, name: str):
        rt = self.manager.get_siddhi_app_runtime(name)
        if rt is None:
            raise KeyError(f"app '{name}' is not deployed")
        return rt

    def _get(self, h):
        from urllib.parse import parse_qs, urlsplit

        split = urlsplit(h.path)
        parts = [p for p in split.path.split("/") if p]
        if parts == ["apps"]:
            h._send(200, {"apps": sorted(self.manager.app_runtimes)})
            return
        if len(parts) == 3 and parts[0] == "apps" and parts[2] == "statistics":
            h._send(200, self._rt(parts[1]).statistics())
            return
        if parts == ["programs"]:
            from siddhi_tpu_torch.core.util import program_cache
            from siddhi_tpu_torch.observability import costmodel

            payload = costmodel.registry().snapshot()
            payload["cache"] = program_cache.cache().snapshot()
            h._send(200, payload)
            return
        if parts and parts[0] in _UNPORTED:
            h._send_unported(_UNPORTED[parts[0]])
            return
        if parts and parts[0] == "metrics" and len(parts) <= 2:
            from siddhi_tpu_torch.observability import export

            app = parts[1] if len(parts) == 2 else None
            if app is not None and self.manager.get_siddhi_app_runtime(
                    app) is None:
                h._send(404, {"error": f"app '{app}' is not deployed"})
                return
            fmt = (parse_qs(split.query).get("format", [""])[0]
                   or ("json" if "application/json"
                       in (h.headers.get("Accept") or "") else "text"))
            if fmt == "json":
                snap = export.json_snapshot(self.manager)
                if app is not None:
                    snap = {"apps": {app: snap["apps"][app]},
                            "process": snap["process"]}
                h._send(200, snap)
            else:
                h._send_text(200, export.prometheus_text(
                    self.manager, app_name=app))
            return
        h._send(404, {"error": f"unknown path {h.path}"})

    def _post(self, h):
        from urllib.parse import parse_qs, urlsplit

        split = urlsplit(h.path)
        parts = [p for p in split.path.split("/") if p]
        if len(parts) == 2 and parts[0] == "ingest":
            # binary wire frame — raw bytes, never the utf-8 _body path
            n = int(h.headers.get("Content-Length", 0))
            raw = h.rfile.read(n) if n else b""
            app = parse_qs(split.query).get("app", [None])[0]
            self._post_ingest(h, parts[1], raw, app)
            return
        body = h._body()
        if parts == ["apps"]:
            if not isinstance(body, str) or not body.strip():
                raise ValueError("POST /apps expects SiddhiQL app text")
            rt = self.manager.create_siddhi_app_runtime(body)
            rt.start()
            h._send(201, {"app": rt.name})
            return
        if parts == ["query"]:
            from siddhi_tpu_torch.resilience import stat_count
            from siddhi_tpu_torch.serving.query_tier import QueryShedError

            rt = self._rt(body["app"])
            try:
                fut = self.admission.try_submit("/query", rt.query, body["query"])
            except QueryShedError as e:
                stat_count(rt.app_context, "resilience.query_sheds")
                h._send_shed(e)
                return
            events = fut.result()
            h._send(200, {"rows": [list(e.data) for e in events]})
            return
        if parts[:2] == ["profile", "costs"] and len(parts) == 3:
            self._post_costs(h, parts[2])
            return
        if parts and parts[0] in _UNPORTED:
            h._send_unported(_UNPORTED[parts[0]])
            return
        if len(parts) == 3 and parts[0] == "apps":
            rt = self._rt(parts[1])
            if parts[2] == "events":
                stream = body["stream"]
                data = body["data"]
                ts = body.get("timestamp")
                rows = data if data and isinstance(data[0], list) else [data]
                handler = rt.get_input_handler(stream)
                for row in rows:
                    if ts is None:
                        handler.send(row)
                    else:
                        handler.send(int(ts), row)
                h._send(200, {"accepted": len(rows)})
                return
            if parts[2] == "persist":
                h._send(200, {"revision": rt.persist()})
                return
            if parts[2] == "trace":
                self._post_app_trace(h, body)
                return
            if parts[2] == "restore":
                rev = body.get("revision") if isinstance(body, dict) else None
                if rev:
                    rt.restore_revision(rev)
                else:
                    rev = rt.restore_last_revision()
                h._send(200, {"revision": rev})
                return
        h._send(404, {"error": f"unknown path {h.path}"})

    def _post_costs(self, h, action: str) -> None:
        """``POST /profile/costs/{start|stop}``: the cost registry's
        process-wide switch, answered as the reference answers it."""
        from siddhi_tpu_torch.observability import costmodel

        if action not in ("start", "stop"):
            h._send(404, {"error": f"unknown path {h.path}"})
            return
        if action == "start":
            costmodel.enable()
        else:
            costmodel.disable()
        h._send(200, {"costs": costmodel.enabled(),
                      "programs": len(costmodel.registry().programs())})

    def _post_app_trace(self, h, body) -> None:
        """``POST /apps/<name>/trace``: the body is validated as the
        reference validates it (400s, trace directories confined under
        ``trace_base``); a valid start answers 501, and a stop 409: no
        device profiler trace can be running."""
        if not isinstance(body, dict) or body.get("action") not in (
                "start", "stop"):
            h._send(400, {"error": "trace expects action=start|stop"})
            return
        if body["action"] == "stop":
            h._send(409, {"error": "no trace is running: " + _APP_TRACE})
            return
        name = body.get("dir")
        if not isinstance(name, str) or not name:
            h._send(400, {"error": "trace start expects a 'dir' "
                                   "(relative name)"})
            return
        base = os.path.realpath(self.trace_base)
        target = os.path.realpath(os.path.join(base, name))
        if target != base and not target.startswith(base + os.sep):
            h._send(400, {"error": "trace dir escapes the configured "
                                   "trace base"})
            return
        h._send_unported(_APP_TRACE)

    def _post_ingest(self, h, stream: str, raw: bytes,
                     app: Optional[str]) -> None:
        """``POST /ingest/{stream}[?app=name]`` — the columnar front door:
        body = one binary wire frame, decoded by ``decode_frame`` and
        landed through the stream's ``InputHandler.send_columns``, behind
        the admission pool."""
        from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException
        from siddhi_tpu_torch.core.stream.input.wire import decode_frame
        from siddhi_tpu_torch.serving.query_tier import QueryShedError

        if app is not None:
            rt = self.manager.get_siddhi_app_runtime(app)
            if rt is None:
                h._send(404, {"error": f"app '{app}' is not deployed"})
                return
            if stream not in rt.junctions:
                h._send(404, {"error": f"stream '{stream}' is not "
                                       f"defined in app '{app}'"})
                return
        else:
            owners = [r for r in self.manager.app_runtimes.values()
                      if stream in r.junctions]
            if not owners:
                h._send(404, {"error": f"no deployed app defines stream "
                                       f"'{stream}'"})
                return
            if len(owners) > 1:
                h._send(409, {"error": f"stream '{stream}' is defined by "
                                       f"multiple apps "
                                       f"{sorted(r.name for r in owners)} "
                                       f"— disambiguate with ?app=<name>"})
                return
            rt = owners[0]

        def ingest():
            # scope = app name: the registry's delta tables hold THIS
            # app's dictionary ids
            data, ts = decode_frame(
                raw, rt.junctions[stream].definition,
                rt.app_context.string_dictionary, self._wire_decoders,
                scope=rt.name)
            n = len(next(iter(data.values()))) if data else 0
            rt.get_input_handler(stream).send_columns(data, timestamps=ts)
            tel = rt.app_context.telemetry
            tel.count("ingest.wire.frames")
            tel.count("ingest.wire.bytes", len(raw))
            tel.count("ingest.wire.events", n)
            return n

        try:
            fut = self.admission.try_submit(f"/ingest:{rt.name}", ingest)
        except QueryShedError as e:
            h._send_shed(e)
            return
        try:
            accepted = fut.result()
        except SiddhiAppValidationException as e:
            # a malformed frame or a dictionary gap is the client's fault:
            # 400 with the reason, never a 500, never a partial batch
            h._send(400, {"error": str(e)})
            return
        h._send(200, {"accepted": accepted, "stream": stream,
                      "app": rt.name})

    def _delete(self, h):
        parts = [p for p in h.path.split("/") if p]
        if len(parts) == 2 and parts[0] == "apps":
            rt = self._rt(parts[1])
            rt.shutdown()
            del self.manager.app_runtimes[parts[1]]
            h._send(200, {"removed": parts[1]})
            return
        h._send(404, {"error": f"unknown path {h.path}"})
