"""Finds a cell's parts by name, under the checkout's ``BENCHMARK.json``.

- a configuration: ``BENCHMARK.json``'s ``configs[].file`` (JSON), with its
  plain reference at ``portbench/reference/<config>.py``;
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a deployment: ``portbench/deployments/<config["deployment"]>.py``;
- a metric, end to end or per layer: ``portbench/metrics/<metric>.py``.

Adding any of them takes new files and new entries, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = "portbench"


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return json.loads((self.root / PKG / "traffic" / f"{name}.json").read_text())

    def reference(self, config: str):
        return self._module("reference", config)

    def deployment(self, name: str):
        return self._module("deployments", name)

    def metric_reader(self, name: str):
        return self._module("metrics", name)

    def metrics(self, cell: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
        those whose ``workloads`` list names it, and those with no list,
        which every cell reports (the end-to-end metrics have none)."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def _module(self, folder: str, name: str):
        path = self.root / PKG / folder / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {folder} module {name!r} at {path}")
        spec = importlib.util.spec_from_file_location(f"{PKG}.{folder}.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
