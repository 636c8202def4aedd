"""Source SPI: external transports feeding streams.

Counterpart of ``siddhi_tpu/core/stream/input/source.py``, the reference
transport-in boundary
(``stream/input/source/Source.java:155-185`` connectWithRetry,
``SourceMapper.java`` payload->event mapping, ``InMemorySource.java:63``).
Mappers produce event rows, which the source runtime sends one by one
through the stream's ``InputHandler``.

Lifecycle: ``SourceRuntime.connect_with_retry`` drives connect() with
exponential backoff on ``ConnectionUnavailableException``;
``pause()/resume()`` gate delivery (the snapshot service pauses sources
around persist(), reference ``SiddhiAppRuntimeImpl.persist``).
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List

from siddhi_tpu_torch.core.util.transport import InMemoryBroker
from siddhi_tpu_torch.query_api.definitions import StreamDefinition


class ConnectionUnavailableException(Exception):
    """Raise from Source.connect / Sink.publish when the transport is
    down — the runtime retries with backoff (reference
    ``exception/ConnectionUnavailableException.java``)."""


class SourceMapper:
    """Maps transport payloads to event rows (reference
    ``stream/input/source/SourceMapper.java``)."""

    def init(self, stream_def: StreamDefinition, options: Dict[str, str]):
        self.stream_def = stream_def
        self.options = options

    def map(self, payload) -> List[list]:
        """Return a list of data rows (one list per event)."""
        raise NotImplementedError


class PassThroughSourceMapper(SourceMapper):
    """Payload is already a data row (or list of rows)."""

    def map(self, payload) -> List[list]:
        if isinstance(payload, (list, tuple)) and payload and isinstance(
            payload[0], (list, tuple)
        ):
            return [list(p) for p in payload]
        return [list(payload)]


class JsonSourceMapper(SourceMapper):
    """``{"event": {attr: value, ...}}`` or a bare attr->value object (the
    shape of the reference's siddhi-map-json default mapping)."""

    def map(self, payload) -> List[list]:
        obj = json.loads(payload) if isinstance(payload, (str, bytes)) else payload
        if isinstance(obj, list):
            out = []
            for o in obj:
                out.extend(self.map(o))
            return out
        if "event" in obj:
            obj = obj["event"]
        return [[obj.get(a.name) for a in self.stream_def.attributes]]


SOURCE_MAPPERS = {
    "passthrough": PassThroughSourceMapper,
    "json": JsonSourceMapper,
}


class Source:
    """Transport SPI (reference ``Source.java``). Subclasses implement
    connect/disconnect and push payloads via ``self.handler(payload)``."""

    def init(self, stream_def: StreamDefinition, options: Dict[str, str],
             app_context) -> None:
        self.stream_def = stream_def
        self.options = options
        self.app_context = app_context
        self.handler = None          # set by SourceRuntime

    def connect(self) -> None:
        raise NotImplementedError

    def disconnect(self) -> None:
        pass

    def destroy(self) -> None:
        pass


class InMemorySource(Source):
    """``@source(type='inMemory', topic='...')`` — subscribes the broker
    (reference ``InMemorySource.java:63``)."""

    def init(self, stream_def, options, app_context):
        super().init(stream_def, options, app_context)
        topic = options.get("topic")
        if topic is None:
            raise ValueError("@source(type='inMemory') needs a 'topic'")
        src = self

        class _Sub(InMemoryBroker.Subscriber):
            def __init__(self):
                self.topic = topic

            def on_message(self, payload):
                src.handler(payload)

        self._sub = _Sub()

    def connect(self):
        InMemoryBroker.subscribe(self._sub)

    def disconnect(self):
        InMemoryBroker.unsubscribe(self._sub)


SOURCES = {
    "inmemory": InMemorySource,
}


class SourceRuntime:
    """Owns one @source: source + mapper + delivery gate + retry loop."""

    def __init__(self, source: Source, mapper: SourceMapper, input_handler,
                 app_context, retry_interval_ms: int = 100,
                 max_retry_interval_ms: int = 5_000, retry_policy=None):
        from siddhi_tpu_torch.resilience.retry import RetryPolicy

        self.source = source
        self.mapper = mapper
        self.input_handler = input_handler
        self.app_context = app_context
        self.retry_interval_ms = retry_interval_ms
        self.max_retry_interval_ms = max_retry_interval_ms
        # shared backoff policy (resilience/retry.py): unbounded, like the
        # reference's connectWithRetry — the transport may come back hours
        # later; shutdown() is the only way out
        self.retry_policy = retry_policy or RetryPolicy(
            initial_ms=retry_interval_ms, max_ms=max_retry_interval_ms)
        self._resume = threading.Event()
        self._resume.set()
        self._connected = False
        self._shutdown = False
        source.handler = self._on_payload

    # ------------------------------------------------------------ delivery

    def _on_payload(self, payload):
        self._resume.wait()          # paused during persist()
        rows = self.mapper.map(payload)
        if not rows:
            return
        for row in rows:
            self.input_handler.send(row)

    def pause(self):
        self._resume.clear()

    def resume(self):
        self._resume.set()

    @property
    def is_paused(self) -> bool:
        return not self._resume.is_set()

    # ----------------------------------------------------------- lifecycle

    def connect_with_retry(self):
        """Reference Source.connectWithRetry:155-185: exponential backoff
        until the transport accepts the connection, driven by the shared
        retry policy (``resilience/retry.py``)."""
        from siddhi_tpu_torch.resilience import stat_count

        def _connect():
            self.source.connect()
            self._connected = True

        self.retry_policy.run(
            _connect, (ConnectionUnavailableException,),
            stop=lambda: self._shutdown,
            on_retry=lambda *_: stat_count(
                self.app_context, "resilience.source_retries"))

    def shutdown(self):
        self._shutdown = True
        self._resume.set()
        if self._connected:
            self.source.disconnect()
        self.source.destroy()


def create_source_runtime(ann, stream_def: StreamDefinition, input_handler,
                          app_context, extensions: Dict[str, type]):
    """Build a SourceRuntime from a ``@source(type='...', ..., @map(...))``
    annotation (reference ``SiddhiAppRuntimeBuilder`` + extension loader)."""
    from siddhi_tpu_torch.ops.expressions import resolve_in

    opts = {k: v for k, v in ann.elements if k is not None}
    type_name = (opts.pop("type", None) or "").lower()
    if not type_name:
        raise ValueError("@source needs a type")
    cls = resolve_in(extensions, "source", type_name) or SOURCES.get(type_name)
    if cls is None:
        raise ValueError(f"unknown source type '{type_name}'")
    map_ann = ann.annotation("map")
    map_opts = {}
    map_type = "passthrough"
    if map_ann is not None:
        map_opts = {k: v for k, v in map_ann.elements if k is not None}
        map_type = (map_opts.pop("type", None) or "passthrough").lower()
    mcls = resolve_in(extensions, "sourceMapper", map_type) \
        or SOURCE_MAPPERS.get(map_type)
    if mcls is None:
        raise ValueError(f"unknown source map type '{map_type}'")
    mapper = mcls()
    mapper.init(stream_def, map_opts)
    source = cls()
    # namespaced deployment config (reference ConfigReader per extension)
    from siddhi_tpu_torch.core.util.config import ConfigReader

    source.config_reader = ConfigReader(
        getattr(app_context.siddhi_context, "config_manager", None),
        f"source.{type_name}")
    source.init(stream_def, opts, app_context)
    return SourceRuntime(source, mapper, input_handler, app_context)


