"""Window, aggregator and selector ops (``ops/keyed_windows.py``,
``ops/aggregators.py``, ``ops/windows.py``, ``core/plan/selector_plan.py``):
device ms a batch of every kernel on the card but the two hand-written ones
(``csrc/ring_exchange.cu``, ``csrc/distinct_scan.cu``); copies left out."""

HAND_WRITTEN = ("ring_exchange", "peer_exchange", "distinct_scan")


def read(rec):
    s, n = rec.kernels(lambda name: not any(k in name for k in HAND_WRITTEN))
    return s * 1e3 / rec.batches if n and rec.batches else None
