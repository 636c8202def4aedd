"""SiddhiManager: top-level API — app registry + shared context.

Counterpart of ``siddhi_tpu/core/manager.py``. The manager picks the
device its apps run on: the CUDA card unless the caller asks for another
device. With no CUDA device and no explicit choice it raises instead of
quietly running on the CPU.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core.app_runtime import SiddhiAppRuntime
from siddhi_tpu_torch.core.context import SiddhiContext
from siddhi_tpu_torch.query_api.siddhi_app import SiddhiApp


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; an explicit device is taken as is."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "siddhi_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device=\"cpu\" to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


class SiddhiManager:
    def __init__(self, device=None):
        self.siddhi_context = SiddhiContext(resolve_device(device))
        self.app_runtimes: Dict[str, SiddhiAppRuntime] = {}

    @property
    def device(self) -> torch.device:
        return self.siddhi_context.device

    def create_siddhi_app_runtime(self, app: Union[str, SiddhiApp]) -> SiddhiAppRuntime:
        from siddhi_tpu_torch.observability.tracing import span

        if isinstance(app, str):
            with span("compile", chars=len(app)):
                app = SiddhiCompiler.parse(SiddhiCompiler.update_variables(app))
        with span("assemble", app=app.name or ""):
            runtime = SiddhiAppRuntime(app, self.siddhi_context)
        self.app_runtimes[runtime.name] = runtime
        return runtime

    def get_siddhi_app_runtime(self, name: str):
        """The deployed app of that name, or None."""
        return self.app_runtimes.get(name)

    def set_config_manager(self, config_manager):
        self.siddhi_context.config_manager = config_manager

    def set_extension(self, name: str, clazz: type):
        """Register a custom extension (reference SiddhiManager.java:213),
        e.g. ``set_extension("function:custom:plus", Plus)``."""
        self.siddhi_context.extensions[name] = clazz

    setExtension = set_extension

    def set_persistence_store(self, store):
        """Where the apps' ``persist()`` writes revisions
        (``core/util/persistence.py``)."""
        self.siddhi_context.persistence_store = store

    setPersistenceStore = set_persistence_store

    def shutdown(self):
        for rt in list(self.app_runtimes.values()):
            rt.shutdown()
        self.app_runtimes.clear()
