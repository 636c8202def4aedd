"""QueryCallback: user hook on a query's output.

Counterpart of ``siddhi_tpu/core/query/callback.py`` (reference
``QueryCallback.java``): ``receive(timestamp, in_events, remove_events)``
where ``in_events`` are the CURRENT outputs of one emitted batch and
``remove_events`` its EXPIRED outputs, each ``None`` when empty.
"""

from __future__ import annotations

from typing import List, Optional

from siddhi_tpu_torch.core.event import Event


class QueryCallback:
    query_name: str = ""

    def receive(self, timestamp: int, in_events: Optional[List[Event]],
                remove_events: Optional[List[Event]]):
        raise NotImplementedError
