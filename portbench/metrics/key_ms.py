"""Query runtime (``core/query/runtime.py`` ``process_batch``): host ms a
batch of the configuration's query in ``query.key`` (the partition keyer,
the group keyer and the key-capacity check), less the ``sync.*`` spans
inside it."""


def read(rec):
    q = rec.config["query"]
    key = (lambda s: s[0] == "query.key" and s[4].get("query") == q)
    if not rec.batches or not any(key(s) for s in rec.spans):
        return None
    us = rec.self_us(key, lambda s: s[0].startswith("sync."))
    return us / 1e3 / rec.batches
