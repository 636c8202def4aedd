"""Host syncs: calls a batch that block the host on the card, the count of
the program's ``sync.*`` spans."""


def read(rec):
    n = sum(1 for s in rec.spans if s[0].startswith("sync."))
    return n / rec.batches if rec.batches and n else None
