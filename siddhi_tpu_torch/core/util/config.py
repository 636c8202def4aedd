"""Config system: ConfigManager + ConfigReader.

Mirror of reference ``util/config/{ConfigManager,InMemoryConfigManager,
FileConfigManager}.java`` + ``ConfigReader``: deployment-level properties
consulted by the engine (capacity knobs) and handed to extensions
(sources/sinks/stores) as namespaced readers. ``FileConfigManager`` reads a
flat ``key: value`` properties file (a YAML subset — no dependency).

Engine-consulted system keys (SiddhiAppContext startup):
  siddhi_tpu.window_capacity, siddhi_tpu.partition_window_capacity,
  siddhi_tpu.nfa_slots, siddhi_tpu.initial_key_capacity
"""

from __future__ import annotations

from typing import Dict, Optional


class ConfigManager:
    """Deployment config SPI (reference ConfigManager.java:26)."""

    def get_property(self, key: str) -> Optional[str]:
        raise NotImplementedError

    def generate_config_reader(self, namespace: str) -> "ConfigReader":
        return ConfigReader(self, namespace)


class InMemoryConfigManager(ConfigManager):
    def __init__(self, properties: Optional[Dict[str, str]] = None,
                 system_configs: Optional[Dict[str, str]] = None):
        self.properties = dict(properties or {})
        self.properties.update(system_configs or {})

    def get_property(self, key: str) -> Optional[str]:
        return self.properties.get(key)


class FileConfigManager(ConfigManager):
    """Flat `key: value` lines; '#' comments (FileConfigManager.java)."""

    def __init__(self, path: str):
        self.properties: Dict[str, str] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or ":" not in line:
                    continue
                k, v = line.split(":", 1)
                self.properties[k.strip()] = v.strip().strip("'\"")

    def get_property(self, key: str) -> Optional[str]:
        return self.properties.get(key)


class ConfigReader:
    """Namespaced view handed to extensions (reference ConfigReader):
    ``reader.read('topic')`` resolves ``<namespace>.topic``."""

    def __init__(self, manager: Optional[ConfigManager], namespace: str):
        self.manager = manager
        self.namespace = namespace

    def read(self, key: str, default: Optional[str] = None) -> Optional[str]:
        if self.manager is None:
            return default
        v = self.manager.get_property(f"{self.namespace}.{key}")
        return v if v is not None else default

    def get_all_configs(self) -> Dict[str, str]:
        if self.manager is None or not hasattr(self.manager, "properties"):
            return {}
        prefix = self.namespace + "."
        return {k[len(prefix):]: v
                for k, v in self.manager.properties.items()
                if k.startswith(prefix)}
