"""Device (the card): the share of the traced window in which no kernel,
copy or set ran on it."""


def read(rec):
    w = rec.window_s
    return 100.0 * (1.0 - rec.busy_s() / w) if w > 0 else None
