"""Scatter-gather merge for cluster on-demand queries.

Counterpart of ``siddhi_tpu/serving/cluster_gather.py``: the pure merge
that ``cluster/router.ClusterRuntime.query`` calls.

A PINNED app answers from its one owner worker — one part, returned
verbatim, so the result is bit-identical to the single-process runtime.
A SPLIT app fans out to every worker and each part covers a DISJOINT
key range (``crc32(key) % n`` ownership), so the stitch is the PR-6
sharded-aggregation rule (``serving/sharded_aggregation.py``): order
the union deterministically by a total row key, and fold buckets that
more than one shard reports. Disjoint ownership makes genuine
cross-shard buckets impossible in steady state — a duplicate bucket
here is the same snapshot row surfacing from two shards (e.g. a query
against a replicated table), which folds to a single copy, the
``first`` rule of the base-spec fold table.
"""

from __future__ import annotations

import heapq
from typing import List


def _row_key(row):
    """Total deterministic order over (ts, values) query rows. ``repr``
    per value keeps mixed-type columns comparable (ints never compare
    with strings directly) while staying exact for the types the wire
    carries."""
    ts, values = row[0], row[1]
    return (ts, tuple(repr(v) for v in values))


def gather_query_rows(parts: List[list]) -> list:
    """Merge per-worker on-demand query results into one deterministic
    answer. One part passes through untouched (exact single-process
    order); multiple parts heapq-stitch by row key with value-identical
    duplicate buckets folded."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return []
    if len(parts) == 1:
        return list(parts[0])
    merged = heapq.merge(*(sorted(p, key=_row_key) for p in parts),
                         key=_row_key)
    out: list = []
    last_key = None
    for row in merged:
        key = _row_key(row)
        if key == last_key:
            continue            # duplicate bucket: fold to one copy
        out.append(row)
        last_key = key
    return out
