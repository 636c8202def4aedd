"""Ranked lock factory: the runtime half of the lock-order rule.

Counterpart of ``siddhi_tpu/analysis/locks.py``. The engine creates its
ordered locks through ``make_lock(rank)`` instead of
``threading.RLock()``. With sanitizers off (the default) this returns a
plain ``threading.RLock``. Under ``SIDDHI_TPU_SANITIZE=1`` it returns a
``CheckedRLock`` that tracks per-thread held ranks and raises
``LockOrderError`` the moment an acquisition inverts the partial order
declared in ``analysis/lockorder.py`` — turning a would-be deadlock that
needs two racing threads to reproduce into a deterministic single-thread
failure. An undeclared rank raises in both modes.
"""

from __future__ import annotations

import threading

from siddhi_tpu_torch.analysis import lockorder


class LockOrderError(RuntimeError):
    """A lock acquisition inverted the declared partial order."""


_TLS = threading.local()
# CheckedRLock acquisitions made in this process (read by acquisitions())
_COUNT = [0]
_COUNT_LOCK = threading.Lock()


def _held():
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def held_ranks() -> frozenset:
    """Ranks of every ``CheckedRLock`` the CALLING thread currently
    holds — the guarded-by sanitizer's (``analysis/guards.py``) oracle.
    Empty when sanitize is off (plain RLocks leave no trace)."""
    return frozenset(rank for rank, _ in _held())


def acquisitions() -> int:
    """``CheckedRLock`` acquisitions made in this process so far."""
    return _COUNT[0]


def _check_rank(rank: str) -> None:
    if rank not in lockorder.RANKS:
        raise ValueError(f"undeclared lock rank '{rank}' — add it to "
                         "analysis/lockorder.py RANKS")


class CheckedRLock:
    """Re-entrant lock that asserts the declared acquisition order.

    Same-rank nesting is allowed (owner locks chain down emit cascades);
    re-entry on the SAME lock object is always allowed (RLock
    semantics). Only cross-rank inversions raise."""

    __slots__ = ("_lock", "rank")

    def __init__(self, rank: str):
        _check_rank(rank)
        self._lock = threading.RLock()
        self.rank = rank

    def _check(self) -> None:
        stack = _held()
        for held_rank, held_id in stack:
            if held_id == id(self):
                return      # re-entrant on the same lock: always fine
            if lockorder.inversion(held_rank, self.rank):
                raise LockOrderError(
                    f"lock-order inversion: acquiring '{self.rank}' "
                    f"({lockorder.RANKS[self.rank]}) while holding "
                    f"'{held_rank}' ({lockorder.RANKS[held_rank]}) — "
                    f"declared order requires '{self.rank}' before "
                    f"'{held_rank}' (analysis/lockorder.py)")

    def acquire(self, blocking: bool = True, timeout: float = -1):
        self._check()
        got = self._lock.acquire(blocking, timeout)
        if got:
            _held().append((self.rank, id(self)))
            with _COUNT_LOCK:
                _COUNT[0] += 1
        return got

    def release(self) -> None:
        self._lock.release()
        stack = _held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][1] == id(self):
                del stack[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # --- threading.Condition protocol (OrderedEgress wraps its ranked
    # lock in a Condition). wait() fully releases the inner RLock via
    # _release_save and reacquires via _acquire_restore; the rank stays
    # on the held stack across the wait on purpose — the waiting thread
    # acquires nothing while blocked, and the predicate runs with the
    # lock (logically and physically) held.

    def _is_owned(self):
        return self._lock._is_owned()

    def _release_save(self):
        return self._lock._release_save()

    def _acquire_restore(self, state):
        self._lock._acquire_restore(state)


def make_lock(rank: str):
    """A ranked re-entrant lock: plain ``threading.RLock`` normally, a
    ``CheckedRLock`` under ``SIDDHI_TPU_SANITIZE=1``. The rank must be
    declared in ``analysis/lockorder.py`` either way."""
    from siddhi_tpu_torch.analysis import sanitize

    _check_rank(rank)
    if sanitize.enabled():
        return CheckedRLock(rank)
    return threading.RLock()
