"""Plain NumPy reference of ``stock_distinct_l10000``: for every row, the
number of distinct symbols among the last ``window`` rows of the stream up
to and including it.

For a checked batch it takes the ``window - 1`` rows before it, counts the
window of the batch's first row directly, and then steps row by row: a row
adds one symbol, less one if its symbol was already in the window, and the
row that leaves takes one away unless its symbol recurs before the new
row (``D(i) = D(i-1) + 1 - [prev(i) > i - W] - [next(i - W) >= i]``).

``control`` is this reference put in the program's place with the tempting
shortcut of a direct-mapped table: a value is its key id modulo the
configuration's ``distinct.capacity`` slots, with no probing, so values
that share a slot count once. It breaks the exact counts the configuration
guarantees.
"""

from __future__ import annotations

import math

import numpy as np

LIMITS = {"distinct_mismatch": 0, "ts_mismatch": 0}


def counts(traffic, g: int, config: dict, slots=None) -> dict:
    W, B = int(config["window"]), traffic.batch
    lo = max(0, g - math.ceil((W - 1) / B))
    ids = traffic.raw_range(lo, g + 1)[config["distinct"]["column"]].astype(np.int64)
    if slots is not None:
        ids = ids % slots
    N = ids.shape[0]
    order = np.argsort(ids, kind="stable")
    sid = ids[order]
    same = sid[1:] == sid[:-1]
    prev = np.full(N, -1, np.int64)
    nxt = np.full(N, np.iinfo(np.int64).max, np.int64)
    prev[order[1:][same]] = order[:-1][same]
    nxt[order[:-1][same]] = order[1:][same]
    i0 = N - B                          # the batch's first row in the history
    d0 = np.unique(ids[max(0, i0 - W + 1):i0 + 1]).shape[0]
    i = np.arange(i0 + 1, N)
    leave = i - W                       # below 0: the stream's first window
    step = (1 - (prev[i] >= np.maximum(i - W + 1, 0))
            - np.where(leave >= 0, nxt[np.maximum(leave, 0)] >= i, False))
    d = np.r_[d0, d0 + np.cumsum(step)]
    return {"ts": traffic.timestamps(g), "distinct": d.astype(np.int64)}


def rows_out(traffic, g: int, config: dict) -> int:
    """The rows send ``g`` has to deliver: one for each input row."""
    return traffic.batch


def expected(traffic, batches, config: dict) -> dict:
    return {g: counts(traffic, g, config) for g in batches}


def control(traffic, batches, config: dict) -> dict:
    """Counts over a direct-mapped table, shaped as the program's outputs."""
    slots = int(config["distinct"]["capacity"])
    return {g: {"__ts__": c["ts"], "distinct": c["distinct"]}
            for g, c in ((g, counts(traffic, g, config, slots)) for g in batches)}


def compare(want: dict, got: dict) -> dict:
    """The rows whose count or timestamp differ over the checked batches; a
    batch missing or of the wrong length counts every row as differing."""
    bad, ts_bad = 0, 0
    for g, w in want.items():
        b = got.get(g)
        n = w["ts"].shape[0]
        if b is None or b["distinct"].shape[0] != n or b["__ts__"].shape[0] != n:
            bad, ts_bad = bad + n, ts_bad + n
            continue
        bad += int((b["distinct"] != w["distinct"]).sum())
        ts_bad += int((b["__ts__"] != w["ts"]).sum())
    return {"distinct_mismatch": bad, "ts_mismatch": ts_bad}
