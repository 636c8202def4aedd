"""Exchange kernel (``ops/exchange.py`` -> ``csrc/ring_exchange.cu``): the
least time the card's memory needs for the exchange the configuration
asks for, over the kernel's device time in the window.

The bytes follow the work, not the implementation: each routed row's
attributes at their declared widths (a string as its 4-byte id), its
8-byte timestamp and its 4-byte partition key, read once and written once.
The padded ``[shards, rows_per_shard]`` buffers are not counted."""

from portbench.peaks import WIDTHS, peak

KERNEL = "ring_exchange_cols_kernel"
TS_BYTES, KEY_BYTES = 8, 4


def row_bytes(schema: dict) -> int:
    return sum(WIDTHS[t] for t in schema.values()) + TS_BYTES + KEY_BYTES


def nbytes(config, rows: dict) -> int:
    """Bytes read and written for ``rows`` sent to each input stream."""
    return sum(2 * n * row_bytes(config["inputs"][s]) for s, n in rows.items())


def read(rec):
    s, n = rec.kernels(lambda name: KERNEL in name)
    bw = peak(rec.device_kind, "hbm_bytes_per_s")
    if not n or bw is None:
        return None
    return 100.0 * nbytes(rec.config, rec.rows) / bw / s
