"""Documentation generator: markdown reference of the queryable surface.

Counterpart of ``siddhi_tpu/utils/docgen.py``, whole.

Mirror of the reference's annotation-driven doc generator
(``siddhi-doc-gen``: walks @Extension metadata into site docs) — here the
source of truth is the engine's own dispatch tables (window factories,
expression built-ins, aggregators, transport registries) plus any
extensions registered on a ``SiddhiManager``.
"""

from __future__ import annotations

import inspect
from typing import Optional

_WINDOWS_DEVICE = [
    ("length(n)", "sliding count window"),
    ("lengthBatch(n)", "tumbling count window"),
    ("time(t)", "sliding time window"),
    ("timeBatch(t[, startTime])", "tumbling time window"),
    ("externalTime(tsAttr, t)", "sliding window on an event-time attribute"),
    ("externalTimeBatch(tsAttr, t[, startTime[, timeout]])", "tumbling external-time window"),
    ("batch()", "per-chunk batch window"),
    ("timeLength(t, n)", "time+count bounded sliding window"),
    ("delay(t)", "emits events delayed by t"),
    ("hopping(windowT, hopT)", "trailing window emitted every hop"),
]
_WINDOWS_HOST = [
    ("sort(n, attr[, 'asc'|'desc', ...])", "keeps the n smallest/largest"),
    ("frequent(n[, attrs])", "Misra-Gries frequent keys"),
    ("lossyFrequent(support[, error][, attrs])", "lossy counting"),
    ("session(gap[, key[, allowedLatency]])", "per-key session chunks"),
    ("cron('<expr>')", "flushes on a cron schedule"),
    ("expression('<expr>')", "retention while the expression holds"),
    ("expressionBatch('<expr>')", "flushes when the expression breaks"),
]
_WINDOWS_KEYED = ["length", "lengthBatch", "batch", "time", "timeBatch", "hopping",
                  "externalTime", "timeLength", "delay", "session (incl. allowedLatency)",
                  "sort", "frequent", "lossyFrequent", "cron",
                  "expression", "expressionBatch (per-key host instances)"]
_AGGREGATORS = ["sum", "count", "avg", "min", "max", "stdDev", "and", "or",
                "minForever", "maxForever", "distinctCount", "unionSet"]
_INCREMENTAL_AGGS = ["sum", "count", "avg", "min", "max", "distinctCount"]
_FUNCTIONS = [
    "cast(x, 'type')", "convert(x, 'type')", "ifThenElse(c, a, b)",
    "coalesce(a, b, ...)", "default(x, d)", "maximum(...)", "minimum(...)",
    "instanceOfBoolean/String/Integer/Long/Float/Double(x)",
    "eventTimestamp()", "currentTimeMillis()", "uuid()", "log(...)",
    "createSet(x)", "sizeOfSet(s)",
]
_STREAM_FUNCTIONS = [
    "log([priority,] [message,] [is.event.logged])",
    "pol2Cart(theta, rho[, z])",
]
_SOURCES = ["inMemory(topic)"]
_SINKS = ["inMemory(topic)", "log([prefix])",
          "@distribution(strategy='roundRobin|broadcast|partitioned', @destination...)"]
_MAPPERS = ["passThrough", "json"]
_STORES = ["inMemory (@store)"]


def generate_docs(manager=None, title: str = "siddhi_tpu_torch reference") -> str:
    """Markdown reference of windows, aggregators, functions, transports,
    and (when a manager is given) its registered extensions."""
    out = [f"# {title}", ""]

    def section(name, rows):
        out.append(f"## {name}")
        out.append("")
        for item in rows:
            if isinstance(item, tuple):
                out.append(f"- `{item[0]}` — {item[1]}")
            else:
                out.append(f"- `{item}`")
        out.append("")

    section("Windows (device)", _WINDOWS_DEVICE)
    section("Windows (host)", _WINDOWS_HOST)
    section("Windows (keyed, inside partitions)", _WINDOWS_KEYED)
    section("Attribute aggregators", _AGGREGATORS)
    section("Incremental aggregators (define aggregation)", _INCREMENTAL_AGGS)
    section("Built-in functions", _FUNCTIONS)
    section("Stream functions (#handler)", _STREAM_FUNCTIONS)
    section("Sources", _SOURCES)
    section("Sinks", _SINKS)
    section("Mappers", _MAPPERS)
    section("Table stores", _STORES)

    if manager is not None and getattr(manager.siddhi_context, "extensions", None):
        out.append("## Registered extensions")
        out.append("")
        for name, cls in sorted(manager.siddhi_context.extensions.items()):
            doc = inspect.getdoc(cls) or ""
            first = doc.splitlines()[0] if doc else ""
            out.append(f"- `{name}` ({cls.__name__})" + (f" — {first}" if first else ""))
        out.append("")
    return "\n".join(out)


def write_docs(path: str, manager=None) -> str:
    md = generate_docs(manager)
    with open(path, "w") as f:
        f.write(md)
    return path
