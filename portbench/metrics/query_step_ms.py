"""Query runtime (``core/query/runtime.py``): host ms a batch of the
``query.step`` spans of the configuration's query, less the dispatch
pipeline's drains (``bench.drain``) and the output stream's
``junction.dispatch`` inside them. It holds the keyer, the route prep and
the step's launch, and the wait for the card where the step pulls its
outputs itself."""


def read(rec):
    q, out = rec.config["query"], rec.config["output_stream"]
    us = rec.self_us(
        lambda s: s[0] == "query.step" and s[4].get("query") == q,
        lambda s: s[0] == "bench.drain" or (
            s[0] == "junction.dispatch" and s[4].get("stream") == out))
    return us / 1e3 / rec.batches if rec.batches else None
