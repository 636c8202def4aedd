from siddhi_tpu_torch.core.trigger.trigger import TriggerRuntime

__all__ = ["TriggerRuntime"]
