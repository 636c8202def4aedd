"""Dispatch pipeline (``core/query/completion.py`` ``CompletionPump``): host
ms a batch in the program's ``pipeline.drain`` spans, less the output
stream's ``junction.dispatch`` inside them: the wait for the card's
outputs of a step that handed them to the pipeline, and their meta."""


def read(rec):
    out = rec.config["output_stream"]
    drain = (lambda s: s[0] == "pipeline.drain")
    if not rec.batches or not any(drain(s) for s in rec.spans):
        return None
    us = rec.self_us(
        drain, lambda s: s[0] == "junction.dispatch" and s[4].get("stream") == out)
    return us / 1e3 / rec.batches
