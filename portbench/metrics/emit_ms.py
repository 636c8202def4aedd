"""Output junction and callback (``core/stream/junction.py``,
``LazyColumns``): host ms a batch of the output stream's
``junction.dispatch`` spans, the callback's pull of the columns included."""


def read(rec):
    out = rec.config["output_stream"]
    us = sum(s[3] - s[2] for s in rec.spans
             if s[0] == "junction.dispatch" and s[4].get("stream") == out)
    return us / 1e3 / rec.batches if rec.batches else None
