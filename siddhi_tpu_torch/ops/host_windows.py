"""Host-side window stages: map/comparator-driven windows.

Counterpart of ``siddhi_tpu/ops/host_windows.py``, a copy with its imports
pointed at the port (numpy only, as in the reference).

Sort, frequent (Misra-Gries), lossyFrequent and session windows are
key/comparator bookkeeping over small collections — per-event hash-map
mutations with no batch parallelism to exploit, exactly the shape the
reference implements with Java maps (``SortWindowProcessor.java:50-78``,
``FrequentWindowProcessor.java:117-180``, ``LossyFrequentWindowProcessor``,
``SessionWindowProcessor``). They run on the host over the decoded batch
(the device step then fuses only the selector); throughput-critical windows
(length/time/batch families) stay device-side.

Interface: ``process(batch, now) -> (HostBatch, notify_ts|None)`` with the
same CURRENT/EXPIRED emission contracts as the device stages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.ops.expressions import TS_KEY, TYPE_KEY, VALID_KEY, CompileError

CURRENT, EXPIRED, TIMER, RESET = 0, 1, 2, 3


def _row(cols: Dict[str, np.ndarray], i: int) -> dict:
    return {k: v[i] for k, v in cols.items()}


def _emit(rows: List[dict], col_specs: Dict[str, np.dtype]) -> "HostBatch":
    from siddhi_tpu_torch.core.event import HostBatch, _pad_len

    n = len(rows)
    cap = _pad_len(max(n, 1))
    out = {k: np.zeros(cap, dt) for k, dt in col_specs.items()}
    out[VALID_KEY] = np.zeros(cap, bool)
    out[TYPE_KEY] = np.zeros(cap, np.int8)
    for i, r in enumerate(rows):
        out[VALID_KEY][i] = True
        for k, v in r.items():
            if k in out:
                out[k][i] = v
    return HostBatch(out)


class HostWindowStage:
    host_mode = True
    batch_mode = False

    def __init__(self, col_specs: Dict[str, np.dtype]):
        # emission columns: data cols + ts/type/valid
        self.col_specs = dict(col_specs)
        self.col_specs[TS_KEY] = np.int64
        self.col_specs[TYPE_KEY] = np.int8
        self.col_specs[VALID_KEY] = np.bool_

    def process(self, batch, now: int):
        raise NotImplementedError

    def contents(self):
        """Numpy (cols, valid) probe surface for joins."""
        rows = self._held_rows()
        b = _emit(rows, self.col_specs)
        return b.cols, b.cols[VALID_KEY]

    def _held_rows(self) -> List[dict]:
        raise NotImplementedError

    # persistence hooks
    def snapshot(self) -> dict:
        raise NotImplementedError

    def restore(self, snap: dict):
        raise NotImplementedError


class SortWindowStage(HostWindowStage):
    """``sort(length, attr[, 'asc'|'desc', attr, ...])``: keeps the
    `length` least events under the comparator; overflow evicts the
    greatest as EXPIRED (``SortWindowProcessor.java:63-77``)."""

    def __init__(self, length: int, sort_keys: List[Tuple[str, bool, bool]],
                 col_specs, dictionary):
        super().__init__(col_specs)
        self.length = length
        self.sort_keys = sort_keys  # [(col, descending, is_string)]
        self.dictionary = dictionary
        self._window: List[dict] = []

    def _sort_window(self):
        # stable multi-pass sort supports per-key direction for any type;
        # string columns compare by decoded value, not dictionary id
        for col, desc, is_str in reversed(self.sort_keys):
            if is_str:
                self._window.sort(
                    key=lambda r, c=col: self.dictionary.decode(int(r[c])) or "",
                    reverse=desc)
            else:
                self._window.sort(key=lambda r, c=col: r[c], reverse=desc)

    def process(self, batch, now: int):
        cols = batch.cols
        out_rows: List[dict] = []
        for i in np.nonzero(cols[VALID_KEY])[0]:
            if cols[TYPE_KEY][i] != CURRENT:
                continue
            row = _row(cols, i)
            self._window.append(row)
            if len(self._window) > self.length:
                self._sort_window()
                evicted = dict(self._window.pop())
                evicted[TS_KEY] = now
                evicted[TYPE_KEY] = EXPIRED
                out_rows.append(evicted)
            cur = dict(row)
            cur[TYPE_KEY] = CURRENT
            out_rows.append(cur)
        return _emit(out_rows, self.col_specs), None

    def _held_rows(self):
        return self._window

    def snapshot(self):
        return {"window": [dict(r) for r in self._window]}

    def restore(self, snap):
        self._window = [dict(r) for r in snap["window"]]


class FrequentWindowStage(HostWindowStage):
    """Misra-Gries heavy hitters (``FrequentWindowProcessor.java:117-180``):
    keeps events of the `count` most frequent attribute combinations;
    displaced combinations emit their last event as EXPIRED; events whose
    new combination finds no room are dropped."""

    def __init__(self, count: int, key_cols: List[str], col_specs):
        super().__init__(col_specs)
        self.count = count
        self.key_cols = key_cols
        self._events: Dict[tuple, dict] = {}
        self._counts: Dict[tuple, int] = {}

    def _key(self, row) -> tuple:
        return tuple(row[c].item() if hasattr(row[c], "item") else row[c]
                     for c in self.key_cols)

    def process(self, batch, now: int):
        cols = batch.cols
        out_rows: List[dict] = []
        for i in np.nonzero(cols[VALID_KEY])[0]:
            if cols[TYPE_KEY][i] != CURRENT:
                continue
            row = _row(cols, i)
            key = self._key(row)
            if key in self._events:
                self._events[key] = row
                self._counts[key] += 1
                cur = dict(row)
                cur[TYPE_KEY] = CURRENT
                out_rows.append(cur)
            else:
                self._events[key] = row
                if len(self._events) > self.count:
                    # decrement every OTHER tracked count; zeros fall out
                    for k in list(self._counts):
                        c = self._counts[k] - 1
                        if c == 0:
                            del self._counts[k]
                            expired = dict(self._events.pop(k))
                            expired[TS_KEY] = now
                            expired[TYPE_KEY] = EXPIRED
                            out_rows.append(expired)
                        else:
                            self._counts[k] = c
                    if len(self._events) > self.count:
                        del self._events[key]  # no room: drop the event
                    else:
                        self._counts[key] = 1
                        cur = dict(row)
                        cur[TYPE_KEY] = CURRENT
                        out_rows.append(cur)
                else:
                    self._counts[key] = 1
                    cur = dict(row)
                    cur[TYPE_KEY] = CURRENT
                    out_rows.append(cur)
        return _emit(out_rows, self.col_specs), None

    def _held_rows(self):
        return list(self._events.values())

    def snapshot(self):
        return {"events": {k: dict(v) for k, v in self._events.items()},
                "counts": dict(self._counts)}

    def restore(self, snap):
        self._events = {k: dict(v) for k, v in snap["events"].items()}
        self._counts = dict(snap["counts"])


class LossyFrequentWindowStage(HostWindowStage):
    """Lossy counting (``LossyFrequentWindowProcessor``): emits the event
    as CURRENT when its combination's count passes (support - error) *
    total; per-bucket pruning drops low-frequency combinations as
    EXPIRED."""

    def __init__(self, support: float, error: float, key_cols: List[str], col_specs):
        super().__init__(col_specs)
        self.support = support
        self.error = error
        self.width = max(int(np.ceil(1.0 / error)), 1)
        self.key_cols = key_cols
        self._events: Dict[tuple, dict] = {}
        self._counts: Dict[tuple, Tuple[int, int]] = {}  # key -> (count, bucket)
        self._total = 0
        self._bucket = 1

    def _key(self, row) -> tuple:
        return tuple(row[c].item() if hasattr(row[c], "item") else row[c]
                     for c in self.key_cols)

    def process(self, batch, now: int):
        cols = batch.cols
        out_rows: List[dict] = []
        for i in np.nonzero(cols[VALID_KEY])[0]:
            if cols[TYPE_KEY][i] != CURRENT:
                continue
            row = _row(cols, i)
            self._total += 1
            if self._total != 1:
                self._bucket = int(np.ceil(self._total / self.width))
            key = self._key(row)
            if key in self._events:
                self._events[key] = row
                c, b = self._counts[key]
                self._counts[key] = (c + 1, b)
            else:
                self._events[key] = row
                self._counts[key] = (1, self._bucket - 1)
            c, _b = self._counts[key]
            if c >= (self.support - self.error) * self._total:
                cur = dict(row)
                cur[TYPE_KEY] = CURRENT
                out_rows.append(cur)
            # bucket-boundary pruning
            if self._total % self.width == 0:
                for k in list(self._counts):
                    c, b = self._counts[k]
                    if c + b <= self._bucket:
                        del self._counts[k]
                        expired = dict(self._events.pop(k))
                        expired[TS_KEY] = now
                        expired[TYPE_KEY] = EXPIRED
                        out_rows.append(expired)
        return _emit(out_rows, self.col_specs), None

    def _held_rows(self):
        return list(self._events.values())

    def snapshot(self):
        return {"events": {k: dict(v) for k, v in self._events.items()},
                "counts": dict(self._counts), "total": self._total,
                "bucket": self._bucket}

    def restore(self, snap):
        self._events = {k: dict(v) for k, v in snap["events"].items()}
        self._counts = dict(snap["counts"])
        self._total = snap["total"]
        self._bucket = snap["bucket"]


class SessionWindowStage(HostWindowStage):
    """``session(gap[, key[, allowedLatency]])``: events pass through as
    CURRENT and join their key's open session; a session with no events
    for `gap` expires — its events emit as one EXPIRED chunk. With
    ``allowedLatency``, each key holds a *current* and a *previous*
    session: a gap-expired current session parks as previous until
    ``end + allowedLatency``; only genuinely late (out-of-order) events
    merge into it, while on-time events past the gap start a fresh
    current session (``SessionWindowProcessor.processEventChunk`` /
    ``moveCurrentSessionToPreviousSession`` / ``addLateEvent``,
    SessionWindowProcessor.java:228-432)."""

    def __init__(self, gap_ms: int, key_col: Optional[str], col_specs,
                 latency_ms: int = 0):
        super().__init__(col_specs)
        if latency_ms > gap_ms:
            raise CompileError(
                "session window allowedLatency must not exceed the gap")
        self.gap_ms = gap_ms
        self.key_col = key_col
        self.latency_ms = latency_ms
        # key -> {start, end, rows}; end = last event ts + gap
        self._cur: Dict[object, dict] = {}
        # key -> {start, end, due, rows}; due = end + allowedLatency
        self._prev: Dict[object, dict] = {}

    def _key(self, row):
        if self.key_col is None:
            return ""
        v = row[self.key_col]
        return v.item() if hasattr(v, "item") else v

    def _emit_expired(self, rows, now, out_rows):
        for r in rows:
            expired = dict(r)
            expired[TS_KEY] = now
            expired[TYPE_KEY] = EXPIRED
            out_rows.append(expired)

    def _sweep(self, now, out_rows):
        # currentSessionTimeout: earliest-ending sessions first
        for k in sorted(self._cur, key=lambda k: self._cur[k]["end"]):
            c = self._cur[k]
            if now < c["end"]:
                continue
            del self._cur[k]
            if self.latency_ms > 0:
                p = self._prev.get(k)
                rows = (p["rows"] + c["rows"]) if p is not None else c["rows"]
                self._prev[k] = {"start": c["start"], "end": c["end"],
                                 "due": c["end"] + self.latency_ms,
                                 "rows": rows}
            else:
                self._emit_expired(c["rows"], now, out_rows)
        # previousSessionTimeout: the latency hold has passed
        for k in sorted(self._prev, key=lambda k: self._prev[k]["end"]):
            p = self._prev[k]
            if now >= p["due"]:
                del self._prev[k]
                self._emit_expired(p["rows"], now, out_rows)

    def _merge_prev_into_cur(self, key):
        """``mergeWindows``: if the previous session's span reaches the
        current session's start-gap, fold it into the current session."""
        p, c = self._prev.get(key), self._cur.get(key)
        if p is not None and c is not None and \
                p["end"] >= c["start"] - self.gap_ms:
            c["rows"] = p["rows"] + c["rows"]
            c["start"] = p["start"]
            del self._prev[key]

    def process(self, batch, now: int):
        cols = batch.cols
        out_rows: List[dict] = []
        self._sweep(now, out_rows)
        for i in np.nonzero(cols[VALID_KEY])[0]:
            if cols[TYPE_KEY][i] != CURRENT:
                continue
            row = _row(cols, i)
            ts = int(cols[TS_KEY][i])
            key = self._key(row)
            c = self._cur.get(key)
            if c is None:
                self._cur[key] = {"start": ts, "end": ts + self.gap_ms,
                                  "rows": [row]}
            elif ts >= c["start"]:
                if ts <= c["end"]:
                    c["end"] = ts + self.gap_ms
                    c["rows"].append(row)
                else:
                    # on-time event past the gap: a NEW session starts; the
                    # old one parks as previous (a displaced previous emits)
                    if self.latency_ms > 0:
                        p = self._prev.get(key)
                        if p is not None:
                            self._emit_expired(p["rows"], now, out_rows)
                        self._prev[key] = {"start": c["start"], "end": c["end"],
                                           "due": c["end"] + self.latency_ms,
                                           "rows": c["rows"]}
                    else:
                        # reference quirk: with no latency this event is
                        # silently dropped from the window (the timer would
                        # normally have flushed first); we expire inline
                        self._emit_expired(c["rows"], now, out_rows)
                    self._cur[key] = {"start": ts, "end": ts + self.gap_ms,
                                      "rows": [row]}
            else:
                # late (out-of-order) event: addLateEvent
                if not self._add_late(key, ts, row, out_rows, now):
                    continue                  # timed out: drop entirely
            cur = dict(row)
            cur[TYPE_KEY] = CURRENT
            out_rows.append(cur)
        notify = None
        deadlines = [c["end"] for c in self._cur.values()]
        deadlines += [p["due"] for p in self._prev.values()]
        if deadlines:
            notify = min(deadlines)
        return _emit(out_rows, self.col_specs), notify

    def _add_late(self, key, ts, row, out_rows, now) -> bool:
        """Reference ``addLateEvent``; returns False when the event's
        session has timed out (the reference removes it from the chunk)."""
        c = self._cur[key]
        if ts >= c["start"] - self.gap_ms:
            c["rows"].insert(0, row)
            c["start"] = ts
            self._merge_prev_into_cur(key)
            return True
        if self.latency_ms <= 0:
            return False
        p = self._prev.get(key)
        if p is None or ts < p["start"] - self.gap_ms:
            return False
        p["rows"].append(row)
        if ts <= p["end"] - self.gap_ms and ts < p["start"]:
            p["start"] = ts
        else:
            p["end"] = ts + self.gap_ms
            p["due"] = p["end"] + self.latency_ms
            self._merge_prev_into_cur(key)
        return True

    def _held_rows(self):
        return ([r for s in self._cur.values() for r in s["rows"]]
                + [r for s in self._prev.values() for r in s["rows"]])

    def snapshot(self):
        return {
            "cur": {k: {"start": s["start"], "end": s["end"],
                        "rows": [dict(r) for r in s["rows"]]}
                    for k, s in self._cur.items()},
            "prev": {k: {"start": s["start"], "end": s["end"], "due": s["due"],
                         "rows": [dict(r) for r in s["rows"]]}
                     for k, s in self._prev.items()},
        }

    def restore(self, snap):
        self._cur = {k: {"start": s["start"], "end": s["end"],
                         "rows": [dict(r) for r in s["rows"]]}
                     for k, s in snap["cur"].items()}
        self._prev = {k: {"start": s["start"], "end": s["end"], "due": s["due"],
                          "rows": [dict(r) for r in s["rows"]]}
                      for k, s in snap.get("prev", {}).items()}


class CronSchedule:
    """Quartz-style cron subset: ``sec min hour dom mon dow`` with ``*``,
    ``?``, ``*/n``, ``a-b``, ``a,b,c`` fields (reference CronWindowProcessor
    delegates to Quartz; this evaluates next-fire directly)."""

    _RANGES = [(0, 59), (0, 59), (0, 23), (1, 31), (1, 12), (0, 7)]

    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) == 7:
            fields = fields[:6]           # drop the optional year field
        if len(fields) != 6:
            raise CompileError(
                f"cron expression '{expr}' needs 6 fields (sec min hour dom mon dow)")
        self.sets = [self._parse(f, lo, hi)
                     for f, (lo, hi) in zip(fields, self._RANGES)]

    @staticmethod
    def _parse(field: str, lo: int, hi: int) -> Optional[set]:
        if field in ("*", "?"):
            return None                   # any
        out = set()
        for part in field.split(","):
            if part.startswith("*/"):
                step = int(part[2:])
                out.update(range(lo, hi + 1, step))
            elif "-" in part:
                a, b = part.split("-")
                if "/" in b:
                    b, st = b.split("/")
                    out.update(range(int(a), int(b) + 1, int(st)))
                else:
                    out.update(range(int(a), int(b) + 1))
            else:
                out.add(int(part))
        return out

    def next_fire(self, now_ms: int) -> int:
        """First cron time strictly after now_ms."""
        import datetime

        t = datetime.datetime.fromtimestamp(
            now_ms / 1000.0, datetime.timezone.utc
        ).replace(microsecond=0, tzinfo=None) + datetime.timedelta(seconds=1)
        sec_s, min_s, hour_s, dom_s, mon_s, dow_s = self.sets
        for _ in range(4 * 366 * 24 * 60):       # bounded search (minutes)
            if (mon_s is None or t.month in mon_s) and \
               (dom_s is None or t.day in dom_s) and \
               (dow_s is None or t.isoweekday() % 7 in dow_s) and \
               (hour_s is None or t.hour in hour_s) and \
               (min_s is None or t.minute in min_s):
                secs = sorted(sec_s) if sec_s is not None else range(60)
                for s in secs:
                    if s >= t.second:
                        fire = t.replace(second=s)
                        return int(fire.replace(
                            tzinfo=datetime.timezone.utc).timestamp() * 1000)
            t = (t + datetime.timedelta(minutes=1)).replace(second=0)
        raise CompileError("cron expression never fires")


class CronWindowStage(HostWindowStage):
    """``cron('<expr>')``: collects events and flushes them as a batch at
    each cron fire; the previous batch expires (reference
    CronWindowProcessor)."""

    batch_mode = True

    def __init__(self, schedule: CronSchedule, col_specs):
        super().__init__(col_specs)
        self.schedule = schedule
        self._rows: List[dict] = []
        self._prev: List[dict] = []
        self._next_fire: Optional[int] = None

    def process(self, batch, now: int):
        cols = batch.cols
        out_rows: List[dict] = []
        if self._next_fire is None:
            self._next_fire = self.schedule.next_fire(now)
        if now >= self._next_fire:
            for r in self._prev:
                rr = dict(r)
                rr[TS_KEY] = now
                rr[TYPE_KEY] = EXPIRED
                out_rows.append(rr)
            for r in self._rows:
                rr = dict(r)
                rr[TYPE_KEY] = CURRENT
                out_rows.append(rr)
            self._prev = self._rows
            self._rows = []
            self._next_fire = self.schedule.next_fire(now)
        valid = cols[VALID_KEY] & (cols[TYPE_KEY] == CURRENT)
        for i in np.nonzero(valid)[0]:
            self._rows.append(_row(cols, int(i)))
        return _emit(out_rows, self.col_specs), self._next_fire

    def _held_rows(self):
        return list(self._rows)

    def snapshot(self):
        return {"rows": self._rows, "prev": self._prev, "next": self._next_fire}

    def restore(self, snap):
        self._rows = list(snap["rows"])
        self._prev = list(snap["prev"])
        self._next_fire = snap["next"]


def _eval_window_expr(expr, rows: List[dict], new_row: Optional[dict],
                      now: int, dictionary):
    """Evaluate a window-retention expression over the held rows
    (reference ExpressionWindowProcessor vocabulary): ``count()``,
    ``sum/avg/min/max(attr)``, ``first.attr`` / ``last.attr``,
    ``eventTimestamp(first|last)``, ``currentTimeMillis()``, literals and
    arithmetic/compare/logic over them."""
    from siddhi_tpu_torch.query_api.expressions import (
        And, Compare, Constant, Divide, Multiply, Not, Or, Subtract, Add,
        AttributeFunction, Variable,
    )

    def ev(e):
        if isinstance(e, Constant):
            if isinstance(e.value, str):
                return dictionary.encode(e.value)
            return e.value
        if isinstance(e, Variable):
            sid = e.stream_id
            if sid in ("first", "last"):
                row = rows[0] if sid == "first" else rows[-1]
                return row[e.attribute_name]
            raise CompileError(
                "expression window variables must be first.<attr>/last.<attr>")
        if isinstance(e, AttributeFunction):
            name = e.name.lower()
            if name == "count":
                return len(rows)
            if name == "currenttimemillis":
                return now
            if name == "eventtimestamp":
                if e.parameters and isinstance(e.parameters[0], Variable):
                    which = e.parameters[0].attribute_name
                    row = rows[0] if which == "first" else rows[-1]
                    return row[TS_KEY]
                return now
            if name in ("sum", "avg", "min", "max"):
                attr = e.parameters[0].attribute_name
                vals = [r[attr] for r in rows]
                if not vals:
                    return 0 if name in ("sum", "avg") else None
                if name == "sum":
                    return sum(vals)
                if name == "avg":
                    return sum(vals) / len(vals)
                return min(vals) if name == "min" else max(vals)
            raise CompileError(f"expression window function '{e.name}' unsupported")
        if isinstance(e, Add):
            return ev(e.left) + ev(e.right)
        if isinstance(e, Subtract):
            return ev(e.left) - ev(e.right)
        if isinstance(e, Multiply):
            return ev(e.left) * ev(e.right)
        if isinstance(e, Divide):
            return ev(e.left) / ev(e.right)
        if isinstance(e, Compare):
            l, r = ev(e.left), ev(e.right)
            op = e.operator
            return {"==": l == r, "!=": l != r, "<": l < r, "<=": l <= r,
                    ">": l > r, ">=": l >= r}[op]
        if isinstance(e, And):
            return ev(e.left) and ev(e.right)
        if isinstance(e, Or):
            return ev(e.left) or ev(e.right)
        if isinstance(e, Not):
            return not ev(e.expression)
        raise CompileError(f"expression window: unsupported node {type(e).__name__}")

    return bool(ev(expr))


def _parse_window_expr(src: str):
    from siddhi_tpu_torch.compiler.parser import Parser
    from siddhi_tpu_torch.compiler.tokenizer import tokenize

    return Parser(tokenize(src)).parse_expression()


class _DynamicExprMixin:
    """Dynamic ``expression(exprAttr)`` support: the retention expression
    rides on each event; a change re-parses (cached) and applies from that
    event on."""

    def _init_dynamic(self, dictionary, expr_attr):
        self.dictionary = dictionary
        self.expr_attr = expr_attr
        self._expr_src = None      # source text of the expression in force

    def _refresh_expr(self, r: dict):
        if self.expr_attr is None:
            return
        # null expressions keep the previous one in force — nulls surface
        # as the '<attr>?' mask column (the sid itself clamps to 0)
        if r.get(self.expr_attr + "?"):
            return
        sid = r.get(self.expr_attr)
        if sid is None or int(sid) < 0:
            return
        src = self.dictionary.decode(int(sid))
        if not src or src == self._expr_src:
            return
        # parse BEFORE recording: a malformed expression must not poison
        # the change detector for identical later values
        parsed = _parse_window_expr(src)
        self._expr_src = src
        self.expr = parsed

    def _restore_expr(self, src):
        """Re-arm the in-force dynamic expression after a restore."""
        if src:
            self._expr_src = src
            self.expr = _parse_window_expr(src)


class ExpressionWindowStage(_DynamicExprMixin, HostWindowStage):
    """``expression('<expr>')`` sliding retention: after each arrival the
    oldest events are evicted until the expression holds (reference
    ExpressionWindowProcessor)."""

    def __init__(self, expr, col_specs, dictionary, expr_attr=None):
        super().__init__(col_specs)
        self.expr = expr
        self._init_dynamic(dictionary, expr_attr)
        self._rows: List[dict] = []

    def process(self, batch, now: int):
        cols = batch.cols
        out_rows: List[dict] = []
        valid = cols[VALID_KEY] & (cols[TYPE_KEY] == CURRENT)
        for i in np.nonzero(valid)[0]:
            r = _row(cols, int(i))
            self._refresh_expr(r)
            self._rows.append(r)
            rr = dict(r)
            rr[TYPE_KEY] = CURRENT
            out_rows.append(rr)
            # no expression in force yet (dynamic form before the first
            # non-null value): retain everything
            while self.expr is not None and self._rows and not _eval_window_expr(
                self.expr, self._rows, r, now, self.dictionary
            ):
                old = self._rows.pop(0)
                oo = dict(old)
                oo[TS_KEY] = now
                oo[TYPE_KEY] = EXPIRED
                out_rows.append(oo)
        return _emit(out_rows, self.col_specs), None

    def _held_rows(self):
        return list(self._rows)

    def snapshot(self):
        return {"rows": self._rows, "expr_src": self._expr_src}

    def restore(self, snap):
        self._rows = list(snap["rows"])
        self._restore_expr(snap.get("expr_src"))


class ExpressionBatchWindowStage(_DynamicExprMixin, HostWindowStage):
    """``expressionBatch('<expr>')``: when an arrival breaks the
    expression, the collected batch flushes and a new one starts with the
    breaking event (reference ExpressionBatchWindowProcessor)."""

    batch_mode = True

    def __init__(self, expr, col_specs, dictionary, expr_attr=None):
        super().__init__(col_specs)
        self.expr = expr
        self._init_dynamic(dictionary, expr_attr)
        self._rows: List[dict] = []
        self._prev: List[dict] = []

    def process(self, batch, now: int):
        cols = batch.cols
        out_rows: List[dict] = []
        valid = cols[VALID_KEY] & (cols[TYPE_KEY] == CURRENT)
        for i in np.nonzero(valid)[0]:
            r = _row(cols, int(i))
            self._refresh_expr(r)
            self._rows.append(r)
            if self.expr is not None and not _eval_window_expr(
                    self.expr, self._rows, r, now, self.dictionary):
                flush = self._rows[:-1]
                if flush:
                    for p in self._prev:
                        pp = dict(p)
                        pp[TS_KEY] = now
                        pp[TYPE_KEY] = EXPIRED
                        out_rows.append(pp)
                    for f in flush:
                        ff = dict(f)
                        ff[TYPE_KEY] = CURRENT
                        out_rows.append(ff)
                    self._prev = flush
                self._rows = self._rows[-1:]
        return _emit(out_rows, self.col_specs), None

    def _held_rows(self):
        return list(self._rows)

    def snapshot(self):
        return {"rows": self._rows, "prev": self._prev,
                "expr_src": self._expr_src}

    def restore(self, snap):
        self._rows = list(snap["rows"])
        self._prev = list(snap["prev"])
        self._restore_expr(snap.get("expr_src"))


class PartitionedHostWindow(HostWindowStage):
    """Per-partition-key instances of a host window stage, the analog of
    the reference PartitionRuntime creating one WindowProcessor instance
    per key for windows inside ``partition with`` blocks. Rows are split
    by the ``__pk__`` column in first-encounter order and each key's
    sub-batch flows through that key's own stage instance; TIMER rows
    fan out to every live instance."""

    def __init__(self, factory):
        probe = factory()
        super().__init__({})
        self.col_specs = dict(probe.col_specs)
        self._factory = factory
        self._stages: Dict[int, HostWindowStage] = {}

    def process(self, batch, now: int):
        from siddhi_tpu_torch.core.event import HostBatch, _pad_len

        cols = batch.cols
        valid = np.asarray(cols[VALID_KEY])
        pk = cols.get("__pk__")
        pk = np.zeros(len(valid), np.int32) if pk is None else np.asarray(pk)
        types = np.asarray(cols[TYPE_KEY])
        is_timer = valid & (types == TIMER)
        cur_keys = pk[valid & (types == CURRENT)]
        # first-encounter order of the batch's keys
        uniq, first = np.unique(cur_keys, return_index=True)
        targets = [int(k) for k in uniq[np.argsort(first, kind="stable")]]
        if is_timer.any():
            seen = set(targets)
            targets += [k for k in self._stages if k not in seen]
        out_cols_list, notify = [], None
        for k in targets:
            stage = self._stages.get(k)
            if stage is None:
                stage = self._stages[k] = self._factory()
            idx = np.nonzero((valid & (pk == k)) | is_timer)[0]
            sub = HostBatch({c: np.asarray(v)[idx] for c, v in cols.items()})
            sub.cols["__pk__"] = np.full(idx.size, k, np.int32)
            b2, n2 = stage.process(sub, now)
            v2 = b2.cols[VALID_KEY]
            if v2.any():
                out_cols_list.append({c: np.asarray(v)[v2]
                                      for c, v in b2.cols.items()})
            if n2 is not None:
                notify = n2 if notify is None else min(notify, n2)
        if not out_cols_list:
            return _emit([], self.col_specs), notify
        merged = {c: np.concatenate([o[c] for o in out_cols_list])
                  for c in out_cols_list[0]}
        n = merged[VALID_KEY].shape[0]
        cap = _pad_len(n)
        if cap != n:
            for c in list(merged):
                merged[c] = np.concatenate(
                    [merged[c], np.zeros(cap - n, merged[c].dtype)])
        return HostBatch(merged), notify

    def reset_keys(self, ids):
        """@purge: a recycled partition id starts with a fresh instance."""
        for k in ids:
            self._stages.pop(int(k), None)

    def _held_rows(self):
        return [r for s in self._stages.values() for r in s._held_rows()]

    def snapshot(self):
        return {"keys": {str(k): s.snapshot() for k, s in self._stages.items()}}

    def restore(self, snap):
        self._stages = {}
        for k, s in snap.get("keys", {}).items():
            stage = self._factory()
            stage.restore(s)
            self._stages[int(k)] = stage


def create_host_window_stage(window, input_def, resolver, app_context) -> HostWindowStage:
    from siddhi_tpu_torch.ops.types import dtype_of
    from siddhi_tpu_torch.ops.windows import _const_param
    from siddhi_tpu_torch.query_api.expressions import Constant, Variable

    name = window.name.lower()
    col_specs: Dict[str, np.dtype] = {}
    for a in input_def.attributes:
        col_specs[a.name] = dtype_of(a.type)
        col_specs[a.name + "?"] = np.bool_
    col_specs["__gk__"] = np.int32
    col_specs["__pk__"] = np.int32

    if name == "sort":
        from siddhi_tpu_torch.query_api.definitions import AttrType

        length = int(_const_param(window, 0, "length"))
        sort_keys: List[Tuple[str, bool, bool]] = []
        i = 1
        params = window.parameters
        while i < len(params):
            p = params[i]
            if not isinstance(p, Variable):
                raise CompileError("sort window expects attribute parameters")
            attr = input_def.attribute(p.attribute_name)
            desc = False
            if i + 1 < len(params) and isinstance(params[i + 1], Constant) \
                    and str(params[i + 1].value).lower() in ("asc", "desc"):
                desc = str(params[i + 1].value).lower() == "desc"
                i += 1
            sort_keys.append((attr.name, desc, attr.type == AttrType.STRING))
            i += 1
        if not sort_keys:
            raise CompileError("sort window needs at least one sort attribute")
        return SortWindowStage(length, sort_keys, col_specs, resolver.dictionary)

    if name == "frequent":
        count = int(_const_param(window, 0, "count"))
        key_cols = [input_def.attribute(p.attribute_name).name
                    for p in window.parameters[1:]]
        if not key_cols:
            key_cols = [a.name for a in input_def.attributes]
        return FrequentWindowStage(count, key_cols, col_specs)

    if name == "lossyfrequent":
        support = float(_const_param(window, 0, "support"))
        error = support / 10.0
        if len(window.parameters) >= 2 and isinstance(window.parameters[1], Constant) \
                and not isinstance(window.parameters[1].value, str):
            error = float(window.parameters[1].value)
            rest = window.parameters[2:]
        else:
            rest = window.parameters[1:]
        key_cols = [input_def.attribute(p.attribute_name).name
                    for p in rest if isinstance(p, Variable)]
        if not key_cols:
            key_cols = [a.name for a in input_def.attributes]
        return LossyFrequentWindowStage(support, error, key_cols, col_specs)

    if name == "session":
        from siddhi_tpu_torch.query_api.expressions import TimeConstant

        gap = int(_const_param(window, 0, "gap"))
        key_col = None
        latency = 0
        for p in window.parameters[1:]:
            if isinstance(p, Variable):
                key_col = input_def.attribute(p.attribute_name).name
            elif (isinstance(p, (TimeConstant, Constant))
                  and not isinstance(p.value, str)):
                latency = int(p.value)
            else:
                raise CompileError(
                    "session parameters are (gap[, key][, allowedLatency])")
        if latency > gap:
            # SessionWindowProcessor.validateAllowedLatency
            raise CompileError(
                "session allowedLatency must not be greater than the session gap")
        return SessionWindowStage(gap, key_col, col_specs, latency)

    if name == "cron":
        expr = _const_param(window, 0, "cron expression")
        if not isinstance(expr, str):
            raise CompileError("cron window needs a quoted cron expression")
        return CronWindowStage(CronSchedule(expr), col_specs)

    if name in ("expression", "expressionbatch"):
        from siddhi_tpu_torch.query_api.definitions import AttrType
        from siddhi_tpu_torch.query_api.expressions import Variable as _Var

        cls = (ExpressionWindowStage if name == "expression"
               else ExpressionBatchWindowStage)
        p0 = window.parameters[0] if window.parameters else None
        if isinstance(p0, _Var):
            # dynamic form — expression(exprAttr): each event CARRIES its
            # retention expression; a change re-parses and re-applies it
            # (reference ExpressionWindowProcessor dynamic parameter)
            try:
                attr = input_def.attribute(p0.attribute_name)
            except Exception:
                raise CompileError(
                    f"{window.name} window: unknown attribute "
                    f"'{p0.attribute_name}'")
            if attr.type != AttrType.STRING:
                raise CompileError(
                    f"{window.name} window's dynamic expression attribute "
                    f"must be a string")
            return cls(None, col_specs, resolver.dictionary,
                       expr_attr=attr.name)
        src = _const_param(window, 0, "expression")
        if not isinstance(src, str):
            raise CompileError(f"{window.name} window needs a quoted expression")
        return cls(_parse_window_expr(src), col_specs, resolver.dictionary)

    raise CompileError(f"host window '{window.name}' is not implemented")
