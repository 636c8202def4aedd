"""Dispatch pipeline (``core/query/completion.py`` ``CompletionPump``): host
ms a batch in the pipeline's drains (``bench.drain``), less the output
stream's ``junction.dispatch`` inside them: the wait for the card's
outputs of a step that handed them to the pipeline, and their meta."""


def read(rec):
    out = rec.config["output_stream"]
    us = rec.self_us(
        lambda s: s[0] == "bench.drain",
        lambda s: s[0] == "junction.dispatch" and s[4].get("stream") == out)
    return us / 1e3 / rec.batches if rec.batches and us else None
