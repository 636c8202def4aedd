"""Input handler and encode (``core/event.py`` ``HostBatch.from_columns``
and ``from_events``): host ms a batch of the program's ``input.encode``
spans of the configuration's input streams, the encode of the sent
columns."""


def read(rec):
    us = sum(s[3] - s[2] for s in rec.spans
             if s[0] == "input.encode" and s[4].get("stream") in rec.rows)
    return us / 1e3 / rec.batches if rec.batches and us else None
