"""Distinct scan kernel (``ops/distinct.py`` -> ``csrc/distinct_scan.cu``):
the least time the card's memory needs for the window's distinct count,
over the device time of the scan's kernels (its offsets and its scan) in
the window.

The bytes follow the work: a batch's inserted values and the values the
window evicts (the same number once the window is full), each read once
at the column's declared width (a string as its 4-byte id), and one 8-byte
count a row written once, over the rows of the streams that hold the
configuration's distinct column."""

from portbench.peaks import WIDTHS, peak

KERNEL = "distinct_scan"
COUNT_BYTES = 8


def nbytes(config, rows: dict) -> int:
    col = config["distinct"]["column"]
    return sum(n * (2 * WIDTHS[config["inputs"][s][col]] + COUNT_BYTES)
               for s, n in rows.items() if col in config["inputs"][s])


def read(rec):
    s, n = rec.kernels(lambda name: KERNEL in name)
    bw = peak(rec.device_kind, "hbm_bytes_per_s")
    if not n or bw is None:
        return None
    return 100.0 * nbytes(rec.config, rec.rows) / bw / s
