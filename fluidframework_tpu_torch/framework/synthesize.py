"""Dependency synthesis: a tiny DI container.

Capability parity with reference packages/framework/synthesize: providers
register by key (type name); scopes synthesize an object exposing the
requested optional/required providers; parent containers chain.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class DependencyContainer:
    def __init__(self, parent: Optional["DependencyContainer"] = None):
        self.parent = parent
        self._providers: Dict[str, Callable[[], Any]] = {}

    def register(self, key: str, provider: Any) -> None:
        """provider: instance or zero-arg factory."""
        self._providers[key] = (provider if callable(provider)
                                else lambda: provider)

    def has(self, key: str) -> bool:
        return key in self._providers or (
            self.parent is not None and self.parent.has(key))

    def resolve(self, key: str) -> Any:
        if key in self._providers:
            return self._providers[key]()
        if self.parent is not None:
            return self.parent.resolve(key)
        raise KeyError(f"no provider for {key!r}")

    def synthesize(self, optional: tuple = (), required: tuple = ()
                   ) -> "SynthesizedScope":
        for key in required:
            if not self.has(key):
                raise KeyError(f"missing required provider {key!r}")
        return SynthesizedScope(self, optional, required)


class SynthesizedScope:
    def __init__(self, container: DependencyContainer,
                 optional: tuple, required: tuple):
        self._container = container
        self._keys = set(optional) | set(required)

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        if key not in self._keys:
            raise AttributeError(f"{key!r} not in synthesized scope")
        if not self._container.has(key):
            return None  # optional, unprovided
        return self._container.resolve(key)
