"""In-memory pub/sub broker for the inMemory source/sink pair.

Counterpart of ``siddhi_tpu/core/util/transport.py`` (reference
``util/transport/InMemoryBroker.java:29``): a static
topic -> subscribers map used by tests and by apps wiring streams across
SiddhiApp instances without an external transport.
"""

from __future__ import annotations

import threading
from typing import Dict, List


class InMemoryBroker:
    _lock = threading.RLock()
    _subscribers: Dict[str, List[object]] = {}

    class Subscriber:
        """Implement ``on_message(payload)`` and ``topic`` (reference
        InMemoryBroker.Subscriber)."""

        topic: str = ""

        def on_message(self, payload):  # pragma: no cover - interface
            raise NotImplementedError

    @classmethod
    def subscribe(cls, subscriber) -> None:
        with cls._lock:
            cls._subscribers.setdefault(subscriber.topic, []).append(subscriber)

    @classmethod
    def unsubscribe(cls, subscriber) -> None:
        with cls._lock:
            subs = cls._subscribers.get(subscriber.topic, [])
            if subscriber in subs:
                subs.remove(subscriber)

    @classmethod
    def publish(cls, topic: str, payload) -> None:
        with cls._lock:
            subs = list(cls._subscribers.get(topic, []))
        for s in subs:
            s.on_message(payload)

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._subscribers.clear()
