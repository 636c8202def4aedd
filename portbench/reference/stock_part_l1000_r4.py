"""Plain NumPy reference of ``stock_part_l1000_r4``: for every row, over the
last ``window`` rows of its symbol up to and including it, ``avg(price)``
(float64 sums of the float32 prices) and ``sum(volume)`` (int64).

It works the windows out again from the generated inputs, the fill
included: for a checked batch it takes as many batches before it as every
symbol of the batch needs to hold ``window - 1`` earlier rows, or the
stream's start. Each symbol's sums restart at its first row in that
history, so their rounding is that of one symbol's rows.

``control`` is this reference put in the program's place one precision
lower than the configuration states (``@app:precision('exact')``: float64
sums; the control sums in float32).
"""

from __future__ import annotations

import math

import numpy as np

# each compared number and its limit (PERF.md gives the readings they
# were set from)
LIMITS = {"avg_err": 1e-9, "volume_mismatch": 0, "ts_mismatch": 0,
          "symbol_map": 0}


def windows(traffic, g: int, config: dict, dtype=np.float64) -> dict:
    """Batch ``g``'s expected outputs: ``ts``, ``key`` (the benchmark's key
    ids), ``avg`` and ``volume``."""
    W, B = int(config["window"]), traffic.batch
    col = config["keys"]["column"]
    step = max(1, math.ceil(1.3 * W * traffic.n_keys / B))
    lo = max(0, g - step)
    while True:
        raw = traffic.raw_range(lo, g + 1)
        ids = raw[col]
        if lo == 0:
            break
        before = np.bincount(ids[:-B], minlength=traffic.n_keys)
        if before[np.unique(ids[-B:])].min() >= W - 1:
            break
        lo = max(0, lo - step)
    N = ids.shape[0]
    key = ids.astype(np.int16 if traffic.n_keys < (1 << 15) else np.int64)
    order = np.argsort(key, kind="stable")
    sid = ids[order]
    starts = np.flatnonzero(np.r_[True, sid[1:] != sid[:-1]])
    bounds = np.r_[starts, N]
    block = np.repeat(np.arange(starts.shape[0]), np.diff(bounds))
    rank = np.arange(N) - starts[block]
    price = raw["price"][order].astype(dtype)
    vol = raw["volume"][order].astype(np.int64)
    cp = np.empty(N, dtype)
    cv = np.empty(N, np.int64)
    for a, b in zip(bounds[:-1], bounds[1:]):
        np.cumsum(price[a:b], out=cp[a:b])
        np.cumsum(vol[a:b], out=cv[a:b])
    pos = np.empty(N, np.int64)
    pos[order] = np.arange(N)
    e = pos[N - B:]
    n = np.minimum(rank[e], W - 1) + 1
    s = e - n + 1                       # the window's first sorted position
    first = s == starts[block[e]]
    sp = cp[e] - np.where(first, 0, cp[np.maximum(s - 1, 0)])
    sv = cv[e] - np.where(first, 0, cv[np.maximum(s - 1, 0)])
    return {"ts": traffic.timestamps(g), "key": ids[N - B:],
            "avg": sp / n.astype(dtype), "volume": sv}


def rows_out(traffic, g: int, config: dict) -> int:
    """The rows send ``g`` has to deliver: one for each input row."""
    return traffic.batch


def expected(traffic, batches, config: dict) -> dict:
    return {g: windows(traffic, g, config) for g in batches}


def control(traffic, batches, config: dict) -> dict:
    """The reference in float32, shaped as the program's outputs."""
    out = {}
    for g in batches:
        w = windows(traffic, g, config, np.float32)
        out[g] = {"__ts__": w["ts"], "symbol": w["key"],
                  "avgPrice": w["avg"].astype(np.float64),
                  "totalVolume": w["volume"]}
    return out


def compare(want: dict, got: dict) -> dict:
    """Each compared number over the checked batches: the worst error of
    ``avgPrice`` (absolute below 1, relative above), the rows whose
    ``totalVolume`` or timestamp differ, and the rows that break a
    one-to-one map between input symbols and output symbol ids. A batch
    missing or of the wrong length counts every row as differing."""
    avg_err, vol_bad, ts_bad = 0.0, 0, 0
    pairs = []
    for g, w in want.items():
        b = got.get(g)
        n = w["ts"].shape[0]
        if b is None or any(b[k].shape[0] != n for k in
                            ("__ts__", "symbol", "avgPrice", "totalVolume")):
            avg_err, vol_bad, ts_bad = math.inf, vol_bad + n, ts_bad + n
            continue
        err = np.abs(b["avgPrice"] - w["avg"]) / np.maximum(np.abs(w["avg"]), 1.0)
        avg_err = max(avg_err, float(np.nan_to_num(err, nan=math.inf).max()))
        vol_bad += int((b["totalVolume"] != w["volume"]).sum())
        ts_bad += int((b["__ts__"] != w["ts"]).sum())
        pairs.append(np.stack([w["key"].astype(np.int64),
                               b["symbol"].astype(np.int64)], 1))
    symbol_map = 0
    if pairs:
        p = np.unique(np.concatenate(pairs), axis=0)
        symbol_map = (2 * p.shape[0] - np.unique(p[:, 0]).shape[0]
                      - np.unique(p[:, 1]).shape[0])
    return {"avg_err": avg_err, "volume_mismatch": vol_bad,
            "ts_mismatch": ts_bad, "symbol_map": int(symbol_map)}
