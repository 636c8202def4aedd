"""Key sharding over a mesh of shards, on one card or across processes
(``mesh.py``), and the process group that spans processes
(``distributed.py``)."""

from siddhi_tpu_torch.parallel.mesh import (
    Mesh,
    batch_shardings,
    device_route_query_step,
    key_axis_sharding,
    make_mesh,
    route_batch_to_shards,
    shard_keyed_query_step,
    shard_query_step,
    state_shardings,
)

__all__ = [
    "Mesh",
    "batch_shardings",
    "device_route_query_step",
    "key_axis_sharding",
    "make_mesh",
    "route_batch_to_shards",
    "shard_keyed_query_step",
    "shard_query_step",
    "state_shardings",
]
