from siddhi_tpu_torch.core.aggregation.incremental import IncrementalAggregationRuntime

__all__ = ["IncrementalAggregationRuntime"]
