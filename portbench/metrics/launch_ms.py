"""Step graphs (``core/query/step_graph.py``, ``QueryRuntime.
_finish_device_batch``): host ms a batch of the configuration's query in
``step.launch`` (the staging copies, the clock's fill, a graph's replay
and its output clones, or the eager step), less the ``sync.*`` spans
inside it (a staging slot's wait)."""


def read(rec):
    q = rec.config["query"]
    launch = (lambda s: s[0] == "step.launch" and s[4].get("query") == q)
    if not rec.batches or not any(launch(s) for s in rec.spans):
        return None
    us = rec.self_us(launch, lambda s: s[0].startswith("sync."))
    return us / 1e3 / rec.batches
