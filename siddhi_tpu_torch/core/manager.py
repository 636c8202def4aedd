"""SiddhiManager: top-level API — app registry + shared context.

Counterpart of ``siddhi_tpu/core/manager.py``. The manager picks the
device its apps run on: the CUDA card unless the caller asks for another
device. With no CUDA device and no explicit choice it raises instead of
quietly running on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core.app_runtime import SiddhiAppRuntime
from siddhi_tpu_torch.core.context import SiddhiContext
from siddhi_tpu_torch.query_api.siddhi_app import SiddhiApp


def _strip_transports(app: SiddhiApp) -> SiddhiApp:
    """Sandbox filter (reference ``SiddhiManager.
    removeSourceSinkAndStoreAnnotations``): drop every @source/@sink whose
    type is not inMemory from stream definitions, and every @store from
    table definitions. Definitions are shallow-copied so a caller-owned
    SiddhiApp object is not mutated."""
    import dataclasses

    def keep_stream_ann(a) -> bool:
        if a.name.lower() not in ("source", "sink"):
            return True
        return (a.element("type") or "").lower() in ("inmemory", "memory")

    streams = {}
    for sid, sdef in app.stream_definitions.items():
        if any(not keep_stream_ann(a) for a in sdef.annotations or []):
            sdef = dataclasses.replace(
                sdef, annotations=[a for a in sdef.annotations if keep_stream_ann(a)])
        streams[sid] = sdef
    tables = {}
    for tid, tdef in app.table_definitions.items():
        if any(a.name.lower() == "store" for a in tdef.annotations or []):
            tdef = dataclasses.replace(
                tdef, annotations=[a for a in tdef.annotations
                                   if a.name.lower() != "store"])
        tables[tid] = tdef
    return dataclasses.replace(app, stream_definitions=streams, table_definitions=tables)


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

    @staticmethod
    def _parse(app: Union[str, SiddhiApp]) -> SiddhiApp:
        from siddhi_tpu_torch.observability.tracing import span

        if isinstance(app, str):
            with span("compile", chars=len(app)):
                app = SiddhiCompiler.parse(SiddhiCompiler.update_variables(app))
        return app

    def _build(self, app: SiddhiApp) -> SiddhiAppRuntime:
        from siddhi_tpu_torch.observability.tracing import span

        with span("assemble", app=app.name or ""):
            return SiddhiAppRuntime(app, self.siddhi_context)

    def create_siddhi_app_runtime(self, app: Union[str, SiddhiApp]) -> SiddhiAppRuntime:
        runtime = self._build(self._parse(app))
        self.app_runtimes[runtime.name] = runtime
        return runtime

    createSiddhiAppRuntime = create_siddhi_app_runtime

    def validate_siddhi_app(self, app: Union[str, SiddhiApp]) -> None:
        """Parse and fully build the app on the manager's device, then
        discard it: creation-time errors surface, nothing is registered or
        started (reference ``SiddhiManager.validateSiddhiApp``)."""
        self._build(self._parse(app)).shutdown()

    validateSiddhiApp = validate_siddhi_app

    def create_sandbox_siddhi_app_runtime(
            self, app: Union[str, SiddhiApp]) -> SiddhiAppRuntime:
        """A runtime with its external transports and stores stripped
        (reference ``SiddhiManager.createSandboxSiddhiAppRuntime``): every
        non-inMemory @source/@sink on a stream and every @store on a table
        is removed, so the app runs fully in-process: feed it with input
        handlers or the InMemoryBroker, observe it with callbacks."""
        return self.create_siddhi_app_runtime(_strip_transports(self._parse(app)))

    createSandboxSiddhiAppRuntime = create_sandbox_siddhi_app_runtime

    def get_siddhi_app_runtime(self, name: str) -> Optional[SiddhiAppRuntime]:
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

    def persist_all(self):
        """Persist every app (reference SiddhiManager.persist)."""
        for rt in self.app_runtimes.values():
            rt.persist()

    persistAll = persist_all

    def restore_last_state(self):
        """Restore every app from its last revision (reference
        SiddhiManager.restoreLastState)."""
        for rt in self.app_runtimes.values():
            rt.restore_last_revision()

    restoreLastState = restore_last_state

    def shutdown(self):
        for rt in list(self.app_runtimes.values()):
            rt.shutdown()
        self.app_runtimes.clear()
