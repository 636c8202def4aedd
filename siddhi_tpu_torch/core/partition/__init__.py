"""Partition keyers (host-side partition-key evaluation)."""

from siddhi_tpu_torch.core.partition.partition import (
    PartitionContext,
    PartitionKeySpace,
    ValuePartitionKeyer,
)

__all__ = ["PartitionContext", "PartitionKeySpace", "ValuePartitionKeyer"]
