"""Routed step (``parallel/mesh.py``): routed dispatches a batch, from the
route layout's ``dispatches`` counter (2 where a batch was split)."""


def read(rec):
    d = rec.delta("route.dispatches")
    return d / rec.batches if d is not None and rec.batches else None
