from siddhi_tpu_torch.core.window.named_window import NamedWindowRuntime

__all__ = ["NamedWindowRuntime"]
