"""Host syncs: host ms a batch in the program's ``sync.*`` spans, each one
call that blocks the host on the card (``sync.meta``, ``sync.columns``,
``sync.staging``, ``sync.lut``)."""


def read(rec):
    us = [s[3] - s[2] for s in rec.spans if s[0].startswith("sync.")]
    return sum(us) / 1e3 / rec.batches if rec.batches and us else None
