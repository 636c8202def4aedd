"""The deterministic-time discipline for differential checks.

Counterpart of ``siddhi_tpu/fuzz/determinism.py``, a copy.

**The lesson (the reference's join check learned it first):** any
window whose expiry is driven by the WALL CLOCK — plain
``window.time``, ``window.timeBatch``, ``window.session`` and their
keyed (partitioned) variants — makes two runs of the same feed only
*approximately* comparable: expiry rides scheduler timers whose firing
order interleaves with batch processing differently run to run, so a
bit-identity diff between two strategies reports phantom divergences.

The fix is never "compare loosely"; it is "generate only windows whose
semantics are a pure function of the DATA": count-driven windows
(``length`` / ``lengthBatch``) and data-driven time windows
(``externalTime`` / ``externalTimeBatch``, which expire off an event
timestamp attribute the feed controls). Every differential harness —
the fuzzer's generator, the quick checks, future bench bit-identity
asserts — must draw windows from this module instead of rediscovering
the rule.

``window.time``/``timeBatch``/``session``/``hopping`` shapes still
deserve coverage for *eligibility classification* (the census: build
the app, read the reason codes, never diff outputs) — that is what
:data:`CENSUS_ONLY_WINDOWS` is for.
"""

from __future__ import annotations

from typing import Optional, Tuple

# Window kinds whose emissions are a pure function of the input feed —
# the ONLY kinds a cross-run differential check may generate. Entries
# are (kind, needs_ts_attr): externalTime variants take the name of a
# long timestamp attribute as their first parameter.
DETERMINISTIC_WINDOWS: Tuple[Tuple[str, bool], ...] = (
    ("length", False),
    ("lengthBatch", False),
    ("externalTime", True),
    ("externalTimeBatch", True),
)

# Wall-clock-driven kinds: valid for census/eligibility classification
# (build + classify, no output diff), NEVER for a bit-identity run.
CENSUS_ONLY_WINDOWS: Tuple[str, ...] = (
    "time", "timeBatch", "session", "hopping", "delay",
)


def is_deterministic(kind: Optional[str]) -> bool:
    """May a differential (bit-identity) check use this window kind?
    ``None`` (no window) is deterministic."""
    if kind is None:
        return True
    return any(kind == k for k, _ in DETERMINISTIC_WINDOWS)


def window_clause(kind: Optional[str], param: int,
                  ts_attr: Optional[str] = None,
                  unit_ms: int = 1000) -> str:
    """Render ``#window.<kind>(...)`` (empty string for ``None``).

    ``param`` is rows for count windows and the span in ``unit_ms``
    multiples for externalTime windows; ``ts_attr`` names the long
    timestamp attribute externalTime variants expire against."""
    if kind is None:
        return ""
    if kind in ("length", "lengthBatch"):
        return f"#window.{kind}({param})"
    if kind in ("externalTime", "externalTimeBatch"):
        if not ts_attr:
            raise ValueError(f"window.{kind} needs a timestamp attribute")
        return f"#window.{kind}({ts_attr}, {param * unit_ms} millisec)"
    if kind == "hopping":
        # census-only shapes render too (the classifier must BUILD the
        # app) — callers assert is_deterministic() before diffing.
        # hopping(windowTime, hopTime) takes two time constants
        return f"#window.hopping({param} sec, {param} sec)"
    if kind in CENSUS_ONLY_WINDOWS:
        return f"#window.{kind}({param} sec)"
    raise ValueError(f"unknown window kind '{kind}'")
