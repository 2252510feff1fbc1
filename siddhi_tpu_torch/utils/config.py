"""Config manager SPI: system-parameter lookup for extensions.

(reference: util/config/ — ConfigManager/ConfigReader interfaces with
InMemoryConfigManager default; extensions read namespaced system params at
init, SiddhiAppParser wires the manager through SiddhiContext.)
"""
from __future__ import annotations

from typing import Dict, Optional


class ConfigReader:
    """Per-namespace view handed to an extension."""

    def __init__(self, namespace: str, configs: Dict[str, str]):
        self.namespace = namespace
        self._configs = configs

    def read_config(self, name: str, default: Optional[str] = None) -> \
            Optional[str]:
        return self._configs.get(f"{self.namespace}.{name}",
                                 self._configs.get(name, default))

    def get_all_configs(self) -> Dict[str, str]:
        prefix = self.namespace + "."
        return {k[len(prefix):]: v for k, v in self._configs.items()
                if k.startswith(prefix)}


class ConfigManager:
    def generate_config_reader(self, namespace: str) -> ConfigReader:
        raise NotImplementedError

    def extract_system_configs(self, name: str) -> Optional[str]:
        raise NotImplementedError


class InMemoryConfigManager(ConfigManager):
    """(reference util/config/InMemoryConfigManager.java)"""

    def __init__(self, configs: Optional[Dict[str, str]] = None,
                 system_configs: Optional[Dict[str, str]] = None):
        self.configs = dict(configs or {})
        self.system_configs = dict(system_configs or {})

    def generate_config_reader(self, namespace: str) -> ConfigReader:
        return ConfigReader(namespace, self.configs)

    def extract_system_configs(self, name: str) -> Optional[str]:
        return self.system_configs.get(name)
