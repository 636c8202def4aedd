"""Shared retry/backoff policy (a copy of ``siddhi_tpu/resilience/retry.py``).

The reference hand-rolls exponential reconnect backoff inside every
transport (``Source.java:155-185``); here the policy is one object shared
by sources, sinks, and the peer transport, so deployment config tunes one
knob set. Backoff is exponential with a multiplicative jitter CAP: the
k-th delay is ``min(initial * multiplier**k, max) * (1 + jitter * u_k)``
with ``u_k`` drawn from a seeded RNG — deterministic for tests, decorrelated
across real deployments that seed differently.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type


class RetryExhausted(Exception):
    """``max_attempts`` retries failed; carries the last cause."""


class RetryPolicy:
    def __init__(self, initial_ms: float = 100, max_ms: float = 5_000,
                 multiplier: float = 2.0, jitter: float = 0.0,
                 max_attempts: Optional[int] = None, seed: int = 0):
        if initial_ms <= 0 or max_ms < initial_ms or multiplier < 1.0:
            raise ValueError("retry policy needs initial_ms > 0, "
                             "max_ms >= initial_ms, multiplier >= 1")
        self.initial_ms = float(initial_ms)
        self.max_ms = float(max_ms)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.max_attempts = max_attempts
        self.seed = seed

    def delays_ms(self) -> Iterator[float]:
        """The (possibly unbounded) backoff schedule, jitter applied."""
        rng = random.Random(self.seed)
        delay = self.initial_ms
        k = 0
        while self.max_attempts is None or k < self.max_attempts:
            capped = min(delay, self.max_ms)
            yield capped * (1.0 + self.jitter * rng.random())
            delay = min(delay * self.multiplier, self.max_ms)
            k += 1

    def run(self, fn: Callable, retry_on: Tuple[Type[BaseException], ...],
            stop: Optional[Callable[[], bool]] = None,
            on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
            sleep: Callable[[float], None] = time.sleep):
        """Call ``fn`` until it succeeds, retrying on ``retry_on`` with this
        policy's backoff. ``stop()`` (checked before every sleep) aborts the
        loop — returns None, the shutdown path of a reconnect loop.
        ``on_retry(attempt, exc, delay_ms)`` observes each failure. Raises
        ``RetryExhausted`` when ``max_attempts`` delays are spent."""
        for attempt, delay in enumerate(self.delays_ms(), start=1):
            if stop is not None and stop():
                return None
            try:
                return fn()
            except retry_on as ex:
                if on_retry is not None:
                    on_retry(attempt, ex, delay)
                if stop is not None and stop():
                    return None
                sleep(delay / 1000.0)
        # a bounded schedule ran dry (unbounded schedules never reach here):
        # one final attempt, then surface the failure
        if stop is not None and stop():
            return None
        try:
            return fn()
        except retry_on as ex:
            raise RetryExhausted(
                f"{self.max_attempts} retries exhausted: {ex}") from ex
