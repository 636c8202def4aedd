"""Cluster fabric: the multi-process tier.

Counterpart of ``siddhi_tpu/cluster/``. One **router** (``ClusterRuntime``,
in the caller's process) owns ingest sequencing, key partitioning and
ordered egress; N **worker processes** each run a full single-process
engine over their key range on the runtime's device (the CUDA card
unless the caller asks for the CPU); a **supervisor** respawns dead
workers, and the router recovers them (restore the last revision, then
replay the router-side WAL suffix). See ``router.py`` for the design.

Not a collective: the links are plain sockets carrying the columnar wire
format (``core/stream/input/wire.py``), so the fabric needs neither a
process group nor more than one card.
"""

from siddhi_tpu_torch.cluster.egress import OrderedEgress
from siddhi_tpu_torch.cluster.router import ClusterRuntime, owner_of_key
from siddhi_tpu_torch.cluster.supervisor import WorkerSupervisor

__all__ = ["ClusterRuntime", "OrderedEgress", "WorkerSupervisor", "owner_of_key"]
