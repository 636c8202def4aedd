"""Key sharding over a mesh of shards, on one card or across processes
(``mesh.py``), and the process group that spans processes
(``distributed.py``)."""

from siddhi_tpu_torch.parallel.mesh import (
    Mesh,
    device_route_query_step,
    make_mesh,
    shard_query_step,
    state_shardings,
)

__all__ = [
    "Mesh",
    "device_route_query_step",
    "make_mesh",
    "shard_query_step",
    "state_shardings",
]
