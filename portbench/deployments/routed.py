"""The app of ``single``, its keyed query routed over ``route.shards``
logical key shards on the one device (``device_route_query_step``), each
shard taking ``route.rows_per_shard`` rows a dispatch."""

from __future__ import annotations

from portbench.deployments.single import build


def deploy(config: dict, device):
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    m, rt, q = build(config, device)
    route = config["route"]
    device_route_query_step(q, make_mesh(int(route["shards"]), device),
                            rows_per_shard=int(route["rows_per_shard"]))
    return m, rt, [q]
