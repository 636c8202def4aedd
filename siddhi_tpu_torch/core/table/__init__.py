from siddhi_tpu_torch.core.table.in_memory_table import (
    InMemoryTable,
    TableConditionResolver,
)

__all__ = ["InMemoryTable", "TableConditionResolver"]
