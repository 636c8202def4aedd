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
- ``GET  /profile/critical_path[/<name>]`` — the batch journeys'
  critical-path report (``observability/journey.py``)
- ``POST /profile/{journeys|costs|device}/start|stop`` — batch journeys,
  program cost capture, the process's device profiler trace
  (``observability/device_trace.py``; ``{"dir": <relative name>}``)
- ``POST /trace/start|stop``           — span tracing
  (``observability/tracing.py``); stop writes the Chrome trace file
  (``{"file": <relative name>}``) and returns it
- ``POST /apps/<name>/trace``          — ``{"action": "start", "dir":
  <relative name>}`` | ``{"action": "stop"}``: the app's device trace
- ``GET  /metrics[/<name>]``           — Prometheus text exposition
  (``observability/export.py``); ``?format=json`` or ``Accept:
  application/json`` returns the JSON snapshot

- ``GET  /autopilot[/<name>]``        — the autopilot's report
  (``autopilot/controller.py``): actuators, decision-log capacity, and per
  registered app its mode, cadence, cooldown, freeze state and decision
  log; 404 for an app that is not deployed or not registered
- ``GET  /cluster``                    — the attached cluster fabric's
  ``status()`` (``cluster/router.py``), 404 with none attached

Every trace file and directory is confined under ``trace_base``: a
client names it relative to that directory, and a name that escapes it
answers 400. With a fabric attached (``SiddhiRestService(m,
cluster=ClusterRuntime(...))``), ``/query`` on a cluster-deployed app
scatter-gathers across the worker processes under the same bounded
admission, and the ``/metrics`` JSON snapshot carries a ``"cluster"``
block (the router's ``cluster.*`` telemetry is on the process registry,
so the Prometheus text needs no routing). An app
whose overload control has a ``query_cap`` (``siddhi_tpu.quota_query_cap``,
``resilience/overload.py``) is admitted to ``/query`` on its own endpoint
``/query:<app>`` against that cap, so one tenant's query storm sheds 503s
without taking its siblings' share of the shared ``/query`` cap; every
other app uses the endpoint's cap. A shed counts
``resilience.query_sheds``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class SiddhiRestService:
    def __init__(self, manager, host: str = "127.0.0.1", port: int = 0,
                 trace_base: Optional[str] = None,
                 query_workers: int = 8, query_queue_cap: int = 64,
                 cluster=None):
        self.manager = manager
        # the optional cluster fabric (cluster/router.ClusterRuntime)
        self.cluster = cluster
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
        self._device_tracing: Optional[str] = None  # the running profile's dir
        # torch's profiler is stopped by the thread that started it: every
        # device-trace start and stop runs on this one thread
        from concurrent.futures import ThreadPoolExecutor

        self._trace_thread = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="siddhi-trace")
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
        self._trace_thread.shutdown(wait=True)

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
        if len(parts) in (2, 3) and parts[:2] == ["profile", "critical_path"]:
            from siddhi_tpu_torch.observability import journey

            app = parts[2] if len(parts) == 3 else None
            if app is not None and self.manager.get_siddhi_app_runtime(app) is None:
                h._send(404, {"error": f"app '{app}' is not deployed"})
                return
            h._send(200, journey.critical_path_report(self.manager, app))
            return
        if parts and parts[0] == "autopilot" and len(parts) <= 2:
            from siddhi_tpu_torch.autopilot import AutopilotController

            app = parts[1] if len(parts) == 2 else None
            if app is not None and self.manager.get_siddhi_app_runtime(app) is None:
                h._send(404, {"error": f"app '{app}' is not deployed"})
                return
            try:
                h._send(200, AutopilotController.instance().report(app))
            except KeyError:
                # deployed but never registered (the autopilot knob off)
                h._send(404, {"error": f"app '{app}' is not under "
                                       f"autopilot control"})
            return
        if parts == ["cluster"]:
            if self.cluster is None:
                h._send(404, {"error": "no cluster fabric is attached"})
                return
            h._send(200, self.cluster.status())
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
                if self.cluster is not None:
                    snap["cluster"] = self.cluster.status()
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

            if self.cluster is not None and body["app"] in self.cluster.apps:
                # a cluster-deployed app: scatter-gather across the worker
                # processes (the router re-merges), under the same bounded
                # admission as in-process queries
                try:
                    fut = self.admission.try_submit(
                        "/query", self.cluster.query, body["app"], body["query"])
                except QueryShedError as e:
                    h._send_shed(e)
                    return
                rows = fut.result()
                h._send(200, {"rows": [list(vals) for _ts, vals in rows]})
                return
            rt = self._rt(body["app"])
            # per-app admission: an app with a query_cap sheds against its
            # own pending count, never the shared '/query' one
            ctl = rt.app_context.overload
            endpoint, cap = "/query", None
            if ctl is not None and ctl.query_cap is not None:
                endpoint, cap = f"/query:{rt.name}", ctl.query_cap
            try:
                fut = self.admission.try_submit(endpoint, rt.query, body["query"],
                                                cap=cap)
            except QueryShedError as e:
                stat_count(rt.app_context, "resilience.query_sheds")
                h._send_shed(e)
                return
            events = fut.result()
            h._send(200, {"rows": [list(e.data) for e in events]})
            return
        if len(parts) == 3 and parts[0] == "profile":
            self._post_profile(h, parts[1], parts[2], body)
            return
        if parts == ["trace", "start"]:
            from siddhi_tpu_torch.observability.tracing import TRACER

            if TRACER.enabled:
                h._send(409, {"error": "span tracing is already running"})
                return
            cap = body.get("capacity") if isinstance(body, dict) else None
            TRACER.start(capacity=int(cap) if cap else None)
            h._send(200, {"tracing": True, "capacity": TRACER.capacity})
            return
        if parts == ["trace", "stop"]:
            self._post_trace_stop(h, body)
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
                self._post_app_trace(h, rt, body)
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

    def _confined(self, name: str, allow_base: bool) -> Optional[str]:
        """``name`` resolved under ``trace_base``, or None when it escapes
        it (``allow_base``: the base itself is a valid directory, never a
        valid file)."""
        base = os.path.realpath(self.trace_base)
        target = os.path.realpath(os.path.join(base, name))
        if target.startswith(base + os.sep) or (allow_base and target == base):
            return target
        return None

    def _post_trace_stop(self, h, body) -> None:
        """``POST /trace/stop``: stop span tracing and write the Chrome
        trace under ``trace_base``; the target is checked before the stop,
        so a refused request leaves the trace running."""
        from siddhi_tpu_torch.observability.tracing import TRACER

        if not TRACER.enabled:
            h._send(409, {"error": "no span trace is running"})
            return
        name = (body.get("file") if isinstance(body, dict) else None) or "spans.trace.json"
        target = self._confined(name, allow_base=False)
        if target is None:
            h._send(400, {"error": "trace file escapes the configured trace base"})
            return
        trace = TRACER.stop()
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with open(target, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        h._send(200, {"tracing": False, "file": target,
                      "events": len(trace["traceEvents"]), "trace": trace})

    def _post_profile(self, h, what: str, action: str, body) -> None:
        """``POST /profile/{journeys|costs|device}/{start|stop}``: the
        process-wide switches of batch journeys, cost capture and the
        device profiler trace, answered as the reference answers them."""
        if action not in ("start", "stop"):
            h._send(404, {"error": f"unknown path {h.path}"})
            return
        if what == "journeys":
            from siddhi_tpu_torch.observability import journey

            if action == "start":
                cap = body.get("capacity") if isinstance(body, dict) else None
                journey.enable(ring_capacity=int(cap) if cap else None)
            else:
                journey.disable()
            h._send(200, {"journeys": journey.enabled()})
            return
        if what == "costs":
            from siddhi_tpu_torch.observability import costmodel

            if action == "start":
                costmodel.enable()
            else:
                costmodel.disable()
            h._send(200, {"costs": costmodel.enabled(),
                          "programs": len(costmodel.registry().programs())})
            return
        if what == "device":
            from siddhi_tpu_torch.observability import device_trace

            if action == "start":
                if self._device_tracing:
                    h._send(409, {"error": "a device profile is already running"})
                    return
                name = (body.get("dir") if isinstance(body, dict) else None) \
                    or "device_profile"
                target = self._confined(name, allow_base=True)
                if target is None:
                    h._send(400, {"error": "profile dir escapes the configured "
                                           "trace base"})
                    return
                try:
                    self._trace_thread.submit(device_trace.start, target).result()
                except RuntimeError as e:     # an app's trace is running
                    h._send(409, {"error": str(e)})
                    return
                self._device_tracing = target
                h._send(200, {"device_profile": target})
            else:
                if not self._device_tracing:
                    h._send(409, {"error": "no device profile is running"})
                    return
                path = self._trace_thread.submit(device_trace.stop).result()
                target, self._device_tracing = self._device_tracing, None
                h._send(200, {"device_profile": None, "dir": target, "file": path})
            return
        h._send(404, {"error": f"unknown path {h.path}"})

    def _post_app_trace(self, h, rt, body) -> None:
        """``POST /apps/<name>/trace``: ``{"action": "start", "dir":
        <relative name>}`` starts the app's device trace under
        ``trace_base``; ``{"action": "stop"}`` stops it (409 for a second
        start or a stop with none running)."""
        if not isinstance(body, dict) or body.get("action") not in (
                "start", "stop"):
            h._send(400, {"error": "trace expects action=start|stop"})
            return
        if body["action"] == "start":
            name = body.get("dir")
            if not isinstance(name, str) or not name:
                h._send(400, {"error": "trace start expects a 'dir' "
                                       "(relative name)"})
                return
            target = self._confined(name, allow_base=True)
            if target is None:
                h._send(400, {"error": "trace dir escapes the configured "
                                       "trace base"})
                return
            try:
                h._send(200, {"tracing": self._trace_thread.submit(
                    rt.start_trace, target).result()})
            except RuntimeError as e:     # a second start
                h._send(409, {"error": str(e)})
            return
        try:
            self._trace_thread.submit(rt.stop_trace).result()
            h._send(200, {"tracing": None})
        except RuntimeError as e:         # a stop with no trace running
            h._send(409, {"error": str(e)})

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
