"""Code loader: resolve code details -> runtime-factory module.

Capability parity with reference packages/loader/web-code-loader (425 LoC,
`WebCodeLoader.load(IFluidCodeDetails) -> IFluidModule`) and the quorum
"code" proposal flow (container.ts code upgrade path; capability
negotiation, SURVEY.md §5 config): a container's *code details* — package
name + version range — select which registered runtime factory drives the
container. The reference fetches bundles from npm/CDN; here modules are
registered in-process (the TPU framework ships as one package), but the
resolution contract — semver-range matching over a registry, highest
matching version wins — is the same. A port of fluidframework_tpu's
loader/code_loader.py: the registry is host only; the device reaches a
container through the Loader that calls it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..core.semver import parse_version, satisfies  # noqa: F401 (re-export)


class FluidModule:
    """IFluidModule: the loaded bundle's entry point. `fluid_export` is the
    runtime factory (reference fluidExport convention)."""

    def __init__(self, fluid_export: Any, package: str, version: str):
        self.fluid_export = fluid_export
        self.package = package
        self.version = version


class CodeLoader:
    """ICodeLoader: registry of (package, version) -> runtime factory."""

    def __init__(self):
        self._registry: Dict[str, List[Tuple[str, Any]]] = {}

    def register(self, package: str, version: str, runtime_factory: Any
                 ) -> None:
        entries = self._registry.setdefault(package, [])
        # Re-registering a version replaces it (registry resolvers may
        # install the same resolved bundle for several containers).
        entries[:] = [(v, f) for v, f in entries if v != version]
        entries.append((version, runtime_factory))

    def load(self, details: Dict[str, Any]) -> FluidModule:
        """Resolve code details {"package": name, "version": range} to the
        highest registered version satisfying the range."""
        package = details["package"]
        spec = details.get("version", "*")
        candidates = [
            (parse_version(version), version, factory)
            for version, factory in self._registry.get(package, [])
            if satisfies(version, spec)]
        if not candidates:
            raise KeyError(
                f"no registered module satisfies {package}@{spec}")
        _, version, factory = max(candidates, key=lambda c: c[0])
        return FluidModule(factory, package, version)
