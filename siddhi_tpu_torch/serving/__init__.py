"""Serving tier: mesh-sharded incremental aggregation, scatter-gather
on-demand queries and admission control.

Counterpart of ``siddhi_tpu/serving/``.
"""

from siddhi_tpu_torch.serving.query_tier import (
    AdmissionPool,
    QueryShedError,
    scatter_pool,
)
from siddhi_tpu_torch.serving.sharded_aggregation import (
    AggregationShard,
    ShardedIncrementalAggregation,
)

__all__ = [
    "AdmissionPool",
    "AggregationShard",
    "QueryShedError",
    "ShardedIncrementalAggregation",
    "scatter_pool",
]
