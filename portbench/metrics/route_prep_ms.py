"""Routed step, host half (``parallel/mesh.py`` ``prepare_routed_batches``):
ms a batch that the histogram ``shard.exchange_ms.<query>`` took in the
window (it holds the host's routing prep, not the exchange)."""


def read(rec):
    name = f"hist.shard.exchange_ms.{rec.config['query']}"
    total, count = rec.delta(f"{name}.sum"), rec.delta(f"{name}.count")
    if not count or not rec.batches:
        return None
    return total / rec.batches
