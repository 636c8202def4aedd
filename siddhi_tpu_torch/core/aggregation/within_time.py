"""Date-string parsing for aggregation ``within`` clauses (a copy of
``siddhi_tpu/core/aggregation/within_time.py``).

The reference resolves ``within`` bounds of incremental-aggregation reads
with ``incrementalAggregator:startTimeEndTime()``
(executor/incremental/IncrementalStartTimeEndTimeFunctionExecutor.java:139-200):
a single string may wildcard trailing calendar fields with ``**`` and means
the whole calendar unit it names ([start, start + unit)); a pair of bounds
may each be a unix-ms long or a fully-specified date string
(IncrementalUnixTimeFunctionExecutor). GMT strings are 19 chars; a
``±HH:MM`` ISO-8601 offset suffix makes 26. Months/years roll
calendar-aware (IncrementalTimeConverterUtil.getNextEmitTime)."""

from __future__ import annotations

import re
from datetime import datetime, timedelta, timezone
from typing import Tuple

_FULL = re.compile(r"^\d{4}-\d{2}-\d{2}\s\d{2}:\d{2}:\d{2}$")
_MIN = re.compile(r"^\d{4}-\d{2}-\d{2}\s\d{2}:\d{2}:\*\*$")
_HOUR = re.compile(r"^\d{4}-\d{2}-\d{2}\s\d{2}:\*\*:\*\*$")
_DAY = re.compile(r"^\d{4}-\d{2}-\d{2}\s\*\*:\*\*:\*\*$")
_MONTH = re.compile(r"^\d{4}-\d{2}-\*\*\s\*\*:\*\*:\*\*$")
_YEAR = re.compile(r"^\d{4}-\*\*-\*\*\s\*\*:\*\*:\*\*$")
_OFFSET = re.compile(r"^(.*)\s([+-])(\d{2}):(\d{2})$")


class WithinFormatError(ValueError):
    pass


def _split_offset(s: str) -> Tuple[str, timezone]:
    """Split an optional trailing ``±HH:MM`` offset; GMT without one."""
    s = s.strip()
    m = _OFFSET.match(s)
    if m and len(s) == 26:
        sign = 1 if m.group(2) == "+" else -1
        delta = timedelta(hours=int(m.group(3)), minutes=int(m.group(4)))
        return m.group(1), timezone(sign * delta)
    if len(s) != 19:
        raise WithinFormatError(
            f"within date '{s}' must be 'yyyy-MM-dd HH:mm:ss' (19 chars, GMT) "
            f"or with a ' ±HH:MM' offset (26 chars); wildcard trailing fields "
            f"with '**'")
    return s, timezone.utc


def unix_ms(s: str) -> int:
    """Epoch ms of a fully-specified ``yyyy-MM-dd HH:mm:ss [±HH:MM]``
    string (IncrementalUnixTimeFunctionExecutor.getUnixTimeStamp)."""
    body, tz = _split_offset(s)
    try:
        dt = datetime.strptime(body, "%Y-%m-%d %H:%M:%S").replace(tzinfo=tz)
    except ValueError as e:
        raise WithinFormatError(f"within date '{s}': {e}") from None
    return int(dt.timestamp() * 1000)


def _next_month(dt: datetime) -> datetime:
    return dt.replace(year=dt.year + 1, month=1) if dt.month == 12 \
        else dt.replace(month=dt.month + 1)


def single_within_range(s: str) -> Tuple[int, int]:
    """[start, end) ms of a single (possibly wildcarded) within string —
    the unit named by the coarsest wildcarded field
    (IncrementalStartTimeEndTimeFunctionExecutor.getStartTimeEndTime)."""
    body, tz = _split_offset(s)
    suffix = "" if tz is timezone.utc else s.strip()[19:]

    if _FULL.match(body):
        start = unix_ms(body + suffix)
        return start, start + 1_000
    if _MIN.match(body):
        start = unix_ms(body.replace("*", "0") + suffix)
        return start, start + 60_000
    if _HOUR.match(body):
        start = unix_ms(body.replace("*", "0") + suffix)
        return start, start + 3_600_000
    if _DAY.match(body):
        start = unix_ms(body.replace("*", "0") + suffix)
        return start, start + 86_400_000
    if _MONTH.match(body):
        head = body.replace("** **:**:**", "01 00:00:00")
        start_dt = datetime.strptime(head, "%Y-%m-%d %H:%M:%S").replace(tzinfo=tz)
        return (int(start_dt.timestamp() * 1000),
                int(_next_month(start_dt).timestamp() * 1000))
    if _YEAR.match(body):
        head = body.replace("**-** **:**:**", "01-01 00:00:00")
        start_dt = datetime.strptime(head, "%Y-%m-%d %H:%M:%S").replace(tzinfo=tz)
        return (int(start_dt.timestamp() * 1000),
                int(start_dt.replace(year=start_dt.year + 1).timestamp() * 1000))
    raise WithinFormatError(
        f"within date '{s}' doesn't match a supported pattern: wildcard "
        f"trailing fields with '**' ('yyyy-MM-dd HH:mm:**' … "
        f"'yyyy-**-** **:**:**')")


def bound_ms(v) -> int:
    """One bound of a two-bound within: unix-ms number or full date string."""
    if isinstance(v, str):
        return unix_ms(v)
    return int(v)


def resolve_within_pair(a, b) -> Tuple[int, int]:
    """[start, end) from two bounds (each unix-ms or a full date string);
    start must precede end (IncrementalStartTimeEndTimeFunctionExecutor
    two-arg validation)."""
    r = (bound_ms(a), bound_ms(b))
    if not r[0] < r[1]:
        raise WithinFormatError(
            f"within start {r[0]} must be less than end {r[1]}")
    return r
