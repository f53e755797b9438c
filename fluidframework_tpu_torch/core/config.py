"""Layered configuration provider.

Capability parity with the reference's nconf-based config system
(server: `nconf` file+env config per service, routerlicious/config/
config.json; lambda plugins take an `nconf.Provider`,
services-core/src/lambdas.ts:56; client: ILoaderOptions /
IContainerRuntimeOptions, containerRuntime.ts:205-208).

Lookup is by dotted path over a stack of layers; later layers win:
defaults < file < environment < overrides. Environment variables use
`PREFIX__a__b=value` (double underscore as the path separator, nconf
style); values parse as JSON when possible, else stay strings.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


def _dig(layer: Dict[str, Any], path: List[str]):
    node: Any = layer
    for part in path:
        if not isinstance(node, dict) or part not in node:
            return None, False
        node = node[part]
    return node, True


class ConfigProvider:
    def __init__(self, *layers: Dict[str, Any]):
        # Lowest priority first.
        self._layers: List[Dict[str, Any]] = [dict(l) for l in layers if l]

    @classmethod
    def from_sources(cls, defaults: Optional[dict] = None,
                     file_path: Optional[str] = None,
                     env_prefix: Optional[str] = None,
                     overrides: Optional[dict] = None) -> "ConfigProvider":
        layers: List[Dict[str, Any]] = []
        if defaults:
            layers.append(defaults)
        if file_path and os.path.exists(file_path):
            with open(file_path) as f:
                layers.append(json.load(f))
        if env_prefix:
            layers.append(cls._env_layer(env_prefix))
        if overrides:
            layers.append(overrides)
        return cls(*layers)

    @staticmethod
    def _env_layer(prefix: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        marker = prefix + "__"
        for key, raw in os.environ.items():
            if not key.startswith(marker):
                continue
            path = key[len(marker):].split("__")
            try:
                value = json.loads(raw)
            except (json.JSONDecodeError, ValueError):
                value = raw
            node = out
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = value
        return out

    # -- lookup ------------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        path = key.split(".") if key else []
        for layer in reversed(self._layers):
            value, found = _dig(layer, path)
            if found:
                return value
        return default

    def require(self, key: str) -> Any:
        sentinel = object()
        value = self.get(key, sentinel)
        if value is sentinel:
            raise KeyError(f"missing required config key {key!r}")
        return value

    def sub(self, prefix: str) -> "ConfigProvider":
        """A provider scoped to one subtree (lambda plugins get their own
        section, mirroring the reference's per-service nconf slices)."""
        sublayers = []
        path = prefix.split(".")
        for layer in self._layers:
            value, found = _dig(layer, path)
            if found and isinstance(value, dict):
                sublayers.append(value)
        return ConfigProvider(*sublayers)

    def with_overrides(self, overrides: Dict[str, Any]) -> "ConfigProvider":
        return ConfigProvider(*self._layers, overrides)
