"""StreamCallback: user hook receiving all events of a stream.

Counterpart of ``siddhi_tpu/core/stream/output/stream_callback.py``:
subscribe to a junction, override ``receive`` (or ``receive_batch`` to
take the columnar batch without decoding it to Events).
"""

from __future__ import annotations

from typing import List

from siddhi_tpu_torch.core.event import Event
from siddhi_tpu_torch.core.stream.junction import Receiver


class StreamCallback(Receiver):
    stream_id: str = ""

    def receive(self, events: List[Event]):
        raise NotImplementedError

    # parity helper with reference's to Event[] signature
    def receive_events(self, events: List[Event]):
        self.receive(events)
