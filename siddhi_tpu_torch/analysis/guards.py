"""Guarded-by field contracts: which fields a lock protects.

Counterpart of ``siddhi_tpu/analysis/guards.py``. A threaded class
declares the contract next to its state:

    @guarded
    class CompletionPump:
        GUARDED_BY = {"_pending": "pump"}

        def __init__(self):
            self._lock = make_lock("pump")
            self._pending = {}

Ranks come from ``lockorder.RANKS``, and ``guarded()`` validates them
whether or not the sanitizer is on. Under ``SIDDHI_TPU_SANITIZE=1`` (read
when the class is defined, the same construction-time gate as
``make_lock``) it installs a data descriptor per declared field that
asserts on EVERY access — from any module, any thread — that the calling
thread holds a lock of the guarding rank (``analysis/locks.py``
per-thread holdings), raising ``GuardViolation`` otherwise. (The
reference's static rule R8 reads the same declarations; the port's lint
engine is ROADMAP A.10 f, static half.)

With sanitize off (the default) the declared fields stay plain instance
attributes: no descriptors, no indirection, no cost. A class decorated
while the env var was set keeps its descriptors, which check nothing
once the env var is unset.

``__init__`` is exempt: construction happens before the instance is
shared, so the constructor populates fields without the lock.

Fields deliberately left OUT of ``GUARDED_BY`` (single-writer beat
counters read by gauge lambdas, lock-free fast-path probes) are simply
not contracts.
"""

from __future__ import annotations

from siddhi_tpu_torch.analysis import lockorder, sanitize


class GuardViolation(RuntimeError):
    """A guarded field was accessed without its declared lock held."""


_CONSTRUCTING = "_guard_constructing"


class _GuardedField:
    """Data descriptor enforcing one ``GUARDED_BY`` entry. The value
    lives in the instance ``__dict__`` under a mangled slot key (a data
    descriptor always wins over a same-named instance attribute, so the
    check cannot be bypassed by plain assignment)."""

    __slots__ = ("name", "rank", "cls_name", "slot")

    def __init__(self, name: str, rank: str, cls_name: str):
        self.name = name
        self.rank = rank
        self.cls_name = cls_name
        self.slot = f"_guarded__{name}"

    def _check(self, obj, op: str) -> None:
        from siddhi_tpu_torch.analysis.locks import held_ranks

        if obj.__dict__.get(_CONSTRUCTING, False):
            return      # constructor: the instance is not shared yet
        if not sanitize.enabled():
            # a class decorated while the env var was set keeps its
            # descriptors; with the env var gone its locks are plain
            # RLocks again, so the check goes inert as the pull guard does
            return
        if self.rank in held_ranks():
            return
        raise GuardViolation(
            f"sanitizer: {op} of {self.cls_name}.{self.name} without "
            f"holding a '{self.rank}'-ranked lock "
            f"({lockorder.RANKS.get(self.rank, '?')}) — the class "
            f"declares GUARDED_BY[{self.name!r}] = {self.rank!r}; "
            f"acquire the lock or amend the contract")

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._check(obj, "unlocked read")
        try:
            return obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(
                f"{self.cls_name!r} object has no attribute "
                f"{self.name!r}") from None

    def __set__(self, obj, value):
        self._check(obj, "unlocked write")
        obj.__dict__[self.slot] = value

    def __delete__(self, obj):
        self._check(obj, "unlocked delete")
        try:
            del obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(
                f"{self.cls_name!r} object has no attribute "
                f"{self.name!r}") from None


def _wrap_init(cls) -> None:
    import functools

    orig = cls.__init__

    @functools.wraps(orig)
    def __init__(self, *args, **kwargs):
        self.__dict__[_CONSTRUCTING] = True
        try:
            orig(self, *args, **kwargs)
        finally:
            self.__dict__.pop(_CONSTRUCTING, None)

    cls.__init__ = __init__


def guarded(cls):
    """Class decorator (or plain call) activating the class's
    ``GUARDED_BY`` declaration. Always validates the declared ranks;
    installs the checking descriptors only when ``SIDDHI_TPU_SANITIZE=1``
    was set at class-definition time (same construction-time gate as
    ``make_lock``)."""
    declared = cls.__dict__.get("GUARDED_BY", None)
    if declared is None:
        raise ValueError(
            f"@guarded class {cls.__name__} has no GUARDED_BY "
            f"declaration of its own")
    for name, rank in declared.items():
        if rank not in lockorder.RANKS:
            raise ValueError(
                f"{cls.__name__}.GUARDED_BY[{name!r}] names undeclared "
                f"lock rank {rank!r} — add it to analysis/lockorder.py "
                f"RANKS")
    if not sanitize.enabled() or not declared:
        return cls
    for name, rank in declared.items():
        setattr(cls, name, _GuardedField(name, rank, cls.__name__))
    _wrap_init(cls)
    return cls
