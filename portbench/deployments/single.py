"""One app on one device: the configuration's SiddhiQL and ``siddhi_tpu.*``
knobs, its key slots (``key_slots``) and distinct value slots
(``distinct.capacity``) set before the first send."""

from __future__ import annotations


def build(config: dict, device):
    """(manager, runtime, query runtime) of ``config`` on ``device``."""
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

    m = SiddhiManager(device=device)
    knobs = config.get("knobs") or {}
    if knobs:
        m.set_config_manager(InMemoryConfigManager(
            {f"siddhi_tpu.{k}": str(v) for k, v in knobs.items()}))
    rt = m.create_siddhi_app_runtime(config["app"])
    q = rt.query_runtimes[config["query"]]
    if "key_slots" in config:
        q.selector_plan.num_keys = int(config["key_slots"])
        if q.partition_ctx is not None:
            q._win_keys = int(config["key_slots"])
    if "distinct" in config:
        for spec in q.selector_plan.specs:
            spec.distinct_capacity = int(config["distinct"]["capacity"])
    return m, rt, q


def deploy(config: dict, device):
    m, rt, q = build(config, device)
    return m, rt, [q]
