"""EventPrinter: debugging print helpers (reference
``util/EventPrinter.java``) — attachable as stream/query callbacks.

Counterpart of ``siddhi_tpu/utils/event_printer.py``, whole."""

from __future__ import annotations

from typing import List, Optional

from siddhi_tpu_torch.core.query.callback import QueryCallback
from siddhi_tpu_torch.core.stream.output.stream_callback import StreamCallback


def print_events(timestamp, in_events: Optional[List], remove_events: Optional[List]):
    """Reference EventPrinter.print(long, Event[], Event[])."""
    print(f"Events{{ @timestamp = {timestamp}, inEvents = {in_events}, "
          f"RemoveEvents = {remove_events} }}")


class PrintingStreamCallback(StreamCallback):
    """`rt.add_callback(stream_id, PrintingStreamCallback())`."""

    def receive(self, events: List):
        print(events)


class PrintingQueryCallback(QueryCallback):
    """`rt.add_callback(query_name, PrintingQueryCallback())`."""

    def receive(self, timestamp, in_events, remove_events):
        print_events(timestamp, in_events, remove_events)
