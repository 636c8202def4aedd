"""Sink SPI: publishing stream output to external transports.

Counterpart of ``siddhi_tpu/core/stream/output/sink.py``, the reference
transport-out boundary
(``stream/output/sink/Sink.java``, ``InMemorySink.java``,
``sink/distributed/*.java`` distribution strategies). A ``SinkRuntime``
subscribes the stream's junction like any other receiver; events are
mapped to payloads by a ``SinkMapper`` and published — through a single
transport, or through several destinations picked by a distribution
strategy (roundRobin / broadcast / partitioned, reference
``RoundRobinDistributionStrategy.java`` etc.).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from siddhi_tpu_torch.core.stream.input.source import ConnectionUnavailableException
from siddhi_tpu_torch.core.stream.junction import Receiver
from siddhi_tpu_torch.core.util.transport import InMemoryBroker
from siddhi_tpu_torch.query_api.definitions import StreamDefinition
from siddhi_tpu_torch.resilience import stat_count
from siddhi_tpu_torch.resilience.retry import RetryPolicy


class SinkMapper:
    """Maps events to transport payloads (reference SinkMapper.java)."""

    def init(self, stream_def: StreamDefinition, options: Dict[str, str]):
        self.stream_def = stream_def
        self.options = options

    def map(self, event) -> object:
        raise NotImplementedError


class PassThroughSinkMapper(SinkMapper):
    def map(self, event):
        return list(event.data)


class JsonSinkMapper(SinkMapper):
    def map(self, event):
        return json.dumps({"event": {
            a.name: event.data[i] for i, a in enumerate(self.stream_def.attributes)
        }})


SINK_MAPPERS = {
    "passthrough": PassThroughSinkMapper,
    "json": JsonSinkMapper,
}


class Sink:
    """Transport SPI (reference Sink.java). Subclasses publish payloads."""

    def init(self, stream_def: StreamDefinition, options: Dict[str, str],
             app_context) -> None:
        self.stream_def = stream_def
        self.options = options
        self.app_context = app_context

    def connect(self) -> None:
        pass

    def publish(self, payload) -> None:
        raise NotImplementedError

    def disconnect(self) -> None:
        pass

    def destroy(self) -> None:
        pass


class InMemorySink(Sink):
    """``@sink(type='inMemory', topic='...')`` (reference InMemorySink)."""

    def init(self, stream_def, options, app_context):
        super().init(stream_def, options, app_context)
        self.topic = options.get("topic")
        if self.topic is None:
            raise ValueError("@sink(type='inMemory') needs a 'topic'")

    def publish(self, payload):
        InMemoryBroker.publish(self.topic, payload)


class LogSink(Sink):
    """``@sink(type='log')`` — prints events (reference siddhi-io log sink
    / EventPrinter-style observability)."""

    def init(self, stream_def, options, app_context):
        super().init(stream_def, options, app_context)
        self.prefix = options.get("prefix", stream_def.id)

    def publish(self, payload):
        print(f"{self.prefix} : {payload}")


SINKS = {
    "inmemory": InMemorySink,
    "log": LogSink,
}


# ------------------------------------------------------- distribution


class DistributionStrategy:
    """Chooses destination indexes per event (reference
    ``sink/distributed/DistributionStrategy.java``)."""

    def init(self, n_destinations: int, stream_def: StreamDefinition,
             options: Dict[str, str]):
        self.n = n_destinations
        self.stream_def = stream_def
        self.options = options

    def destinations_for(self, event) -> List[int]:
        raise NotImplementedError


class RoundRobinStrategy(DistributionStrategy):
    def init(self, n, stream_def, options):
        super().init(n, stream_def, options)
        self._i = 0

    def destinations_for(self, event):
        d = self._i % self.n
        self._i += 1
        return [d]


class BroadcastStrategy(DistributionStrategy):
    def destinations_for(self, event):
        return list(range(self.n))


class PartitionedStrategy(DistributionStrategy):
    """Hash of ``partitionKey`` attribute picks the destination
    (reference PartitionedDistributionStrategy.java)."""

    def init(self, n, stream_def, options):
        super().init(n, stream_def, options)
        key = options.get("partitionKey")
        if key is None:
            raise ValueError("partitioned distribution needs 'partitionKey'")
        self._idx = [a.name for a in stream_def.attributes].index(key)

    def destinations_for(self, event):
        return [hash(event.data[self._idx]) % self.n]


STRATEGIES = {
    "roundrobin": RoundRobinStrategy,
    "broadcast": BroadcastStrategy,
    "partitioned": PartitionedStrategy,
}


class SinkRuntime(Receiver):
    """One @sink subscription on a stream junction."""

    def __init__(self, sinks: List[Sink], mapper: SinkMapper,
                 strategy: Optional[DistributionStrategy], definition,
                 app_context=None, retry_policy=None):
        self.sinks = sinks
        self.mapper = mapper
        self.strategy = strategy
        self.definition = definition
        self.app_context = app_context
        # shared backoff policy (resilience/retry.py): unlike a source
        # reconnect, a publish retry holds the junction's delivery path —
        # bounded attempts, then RetryExhausted rides the stream's
        # @OnError routing like any other processing failure
        self.retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy(initial_ms=10, max_ms=1_000, max_attempts=8)
        self._connected = False
        self._shutdown = False

    def connect(self):
        for s in self.sinks:
            s.connect()
        self._connected = True

    def _publish(self, sink: Sink, payload):
        if self.retry_policy is None:
            sink.publish(payload)
            return
        self.retry_policy.run(
            lambda: sink.publish(payload),
            (ConnectionUnavailableException,),
            # the sink's shutdown must not sit out the remaining backoff
            # sleeps per pending event. (The reference stops at app
            # shutdown, which comes BEFORE @Async workers deliver their
            # queued units: their publishes were skipped without a try.
            # Sinks shut down after the workers have stopped.)
            stop=lambda: self._shutdown,
            on_retry=lambda *_: stat_count(
                self.app_context, "resilience.sink_retries"))

    def receive(self, events):
        for e in events:
            if e.is_expired:
                continue
            payload = self.mapper.map(e)
            if self.strategy is None:
                self._publish(self.sinks[0], payload)
            else:
                for d in self.strategy.destinations_for(e):
                    self._publish(self.sinks[d], payload)

    def receive_batch(self, batch, junction=None):
        # reads the output columns, pulling device-held ones through
        # LazyColumns: a pipelined batch reaches its sinks at drain, never
        # inside the dispatch
        dictionary = (junction.app_context.string_dictionary
                      if junction is not None else None)
        self.receive(batch.to_events(
            [(a.name, a.type) for a in self.definition.attributes], dictionary))

    def shutdown(self):
        self._shutdown = True
        if self._connected:
            for s in self.sinks:
                s.disconnect()
        for s in self.sinks:
            s.destroy()


def create_sink_runtime(ann, stream_def: StreamDefinition, app_context,
                        extensions: Dict[str, type]) -> SinkRuntime:
    """Build a SinkRuntime from ``@sink(type='...', ..., @map(...),
    @distribution(strategy='...', @destination(...), ...))``."""
    from siddhi_tpu_torch.ops.expressions import resolve_in

    opts = {k: v for k, v in ann.elements if k is not None}
    type_name = (opts.pop("type", None) or "").lower()
    if not type_name:
        raise ValueError("@sink needs a type")
    cls = resolve_in(extensions, "sink", type_name) or SINKS.get(type_name)
    if cls is None:
        raise ValueError(f"unknown sink type '{type_name}'")

    map_ann = ann.annotation("map")
    map_opts = {}
    map_type = "passthrough"
    if map_ann is not None:
        map_opts = {k: v for k, v in map_ann.elements if k is not None}
        map_type = (map_opts.pop("type", None) or "passthrough").lower()
    mcls = resolve_in(extensions, "sinkMapper", map_type) or SINK_MAPPERS.get(map_type)
    if mcls is None:
        raise ValueError(f"unknown sink map type '{map_type}'")
    mapper = mcls()
    mapper.init(stream_def, map_opts)

    dist_ann = ann.annotation("distribution")
    if dist_ann is None:
        sink = cls()
        sink.init(stream_def, opts, app_context)
        return SinkRuntime([sink], mapper, None, stream_def,
                           app_context=app_context)

    dist_opts = {k: v for k, v in dist_ann.elements if k is not None}
    strat_name = (dist_opts.pop("strategy", None) or "roundrobin").lower()
    scls = STRATEGIES.get(strat_name)
    if scls is None:
        raise ValueError(f"unknown distribution strategy '{strat_name}'")
    sinks = []
    for dest in dist_ann.annotations:
        if dest.name.lower() != "destination":
            continue
        d_opts = dict(opts)
        d_opts.update({k: v for k, v in dest.elements if k is not None})
        sink = cls()
        sink.init(stream_def, d_opts, app_context)
        sinks.append(sink)
    if not sinks:
        raise ValueError("@distribution needs at least one @destination")
    strategy = scls()
    strategy.init(len(sinks), stream_def, dist_opts)
    return SinkRuntime(sinks, mapper, strategy, stream_def,
                       app_context=app_context)


