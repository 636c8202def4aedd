"""StreamJunction: per-stream pub/sub bus.

Counterpart of ``siddhi_tpu/core/stream/junction.py`` on its synchronous
path: producers publish event chunks or columnar batches and every
subscribed receiver (query runtimes, stream callbacks) gets them in
subscription order on the caller's thread. ``@Async`` buffering and
``@OnError(action='stream')`` fault streams are not ported yet.
"""

from __future__ import annotations

import logging
import traceback
from typing import List

from siddhi_tpu_torch.core.event import Event, HostBatch, LazyColumns
from siddhi_tpu_torch.query_api.definitions import StreamDefinition

log = logging.getLogger(__name__)


class FatalQueryError(RuntimeError):
    """Framework-infrastructure failure (capacity overflow knobs): unlike
    per-event processing errors, which the junction logs and drops like
    the reference, these always propagate to the sender."""


class Receiver:
    """Subscriber interface (reference StreamJunction.Receiver)."""

    def receive(self, events: List[Event]):
        raise NotImplementedError

    def receive_batch(self, batch, junction: "StreamJunction"):
        """Columnar fast path: receivers that consume a HostBatch directly
        override this; the default decodes to Events."""
        self.receive(junction.decode_events(batch))


class StreamJunction:
    def __init__(self, definition: StreamDefinition, app_context):
        self.definition = definition
        self.app_context = app_context
        self.receivers: List[Receiver] = []

    def subscribe(self, receiver: Receiver):
        if receiver not in self.receivers:
            self.receivers.append(receiver)

    def send_events(self, events: List[Event]):
        if not events:
            return
        for r in self.receivers:
            try:
                r.receive(events)
            except Exception as e:  # noqa: BLE001 — per-event fault routing
                self.handle_error(e)

    def decode_events(self, batch) -> List[Event]:
        return batch.to_events(
            [(a.name, a.type) for a in self.definition.attributes],
            self.app_context.string_dictionary,
            object_meta=getattr(self.definition, "object_elem_types", None),
            object_multi=getattr(self.definition, "object_multi_attrs", None))

    def send_batch(self, batch):
        """Columnar publish (no Event objects), delivered as one unit."""
        for r in self.receivers:
            # receivers mutate batch.cols in place (filters, key columns):
            # each gets its own dict; LazyColumns keeps device-held
            # outputs unpulled until read
            sub = HostBatch(LazyColumns(batch.cols), size=batch._size)
            try:
                r.receive_batch(sub, self)
            except Exception as e:  # noqa: BLE001 — per-event fault routing
                self.handle_error(e)

    def handle_error(self, e: Exception):
        from siddhi_tpu_torch.ops.expressions import CompileError

        if isinstance(e, (FatalQueryError, CompileError)):
            # framework failures always surface to the sender
            raise e
        # default action: log and DROP — the reference's StreamJunction
        # never propagates processing errors back to the sender
        log.error("error processing events in stream '%s': %s\n%s",
                  self.definition.id, e, traceback.format_exc())
