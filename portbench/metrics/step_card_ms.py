"""Device (the card): ms a batch of the configuration's query's steps on
the card, from the program's histogram ``step.card_ms.<query>`` (CUDA
events from the card reaching a step to its meta's arrival, gaps inside
the step included; one value a dispatch, recorded while the tracer is
on)."""


def read(rec):
    name = f"hist.step.card_ms.{rec.config['query']}"
    total, count = rec.delta(f"{name}.sum"), rec.delta(f"{name}.count")
    if not count or not rec.batches:
        return None
    return total / rec.batches
