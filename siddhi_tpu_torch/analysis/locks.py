"""Ranked lock factory.

Counterpart of ``siddhi_tpu/analysis/locks.py`` in the form the reference
runs with its sanitizer off: ``make_lock(rank)`` is a plain
``threading.RLock``. The rank names the lock's place in the reference's
lock-order table; the checked lock that validates the order
(``CheckedRLock``, ``SIDDHI_TPU_SANITIZE=1``) is ROADMAP A.10.
"""

from __future__ import annotations

import threading


def make_lock(rank: str):
    """A re-entrant lock for a ``rank`` of the lock-order table."""
    return threading.RLock()
