"""Input handler and encode (``core/stream/input``, ``HostBatch.from_columns``,
``StringDictionary``): host ms a batch in the encode of the sent columns,
the benchmark's ``bench.encode`` span."""


def read(rec):
    us = sum(s[3] - s[2] for s in rec.spans if s[0] == "bench.encode")
    return us / 1e3 / rec.batches if rec.batches and us else None
