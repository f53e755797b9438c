"""Container runtime factories: the code-loading entry points.

Capability parity with reference aqueduct/src/container-runtime-factories/
{baseContainerRuntimeFactory.ts, containerRuntimeFactoryWithDefaultDataStore.ts:25}:
a factory owns the registry of DataObjectFactories and materializes the
default data store on first create; request routing resolves "/" to the
default data object (the reference's request handler chain).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .data_object import DataObjectFactory, PureDataObject
from .request_handler import RequestParser


class BaseContainerRuntimeFactory:
    def __init__(self, registry_entries: Optional[List[DataObjectFactory]]
                 = None):
        self.registry: Dict[str, DataObjectFactory] = {
            f.type: f for f in (registry_entries or [])}
        # Per-container instance cache: one factory serves many containers.
        self._instances: Dict[int, Dict[str, PureDataObject]] = {}

    def _container_instances(self, container) -> Dict[str, PureDataObject]:
        return self._instances.setdefault(id(container.runtime), {})

    def register(self, factory: DataObjectFactory) -> None:
        self.registry[factory.type] = factory

    # -- lifecycle hooks (subclasses) --------------------------------------
    def instantiate_first_time(self, container) -> None:
        """Create-time: build initial data stores."""

    def instantiate_from_existing(self, container) -> None:
        """Load-time: rehydrate data objects from existing stores."""

    def initialize(self, container, existing: bool) -> None:
        if existing:
            self.instantiate_from_existing(container)
        else:
            self.instantiate_first_time(container)

    # -- request routing ---------------------------------------------------
    def request(self, container, url: str):
        parser = RequestParser(url)
        instances = self._container_instances(container)
        store_id = parser.path_parts[0] if parser.path_parts else None
        if store_id in instances:
            return instances[store_id]
        raise KeyError(f"no route for {url!r}")


class ContainerRuntimeFactoryWithDefaultDataStore(BaseContainerRuntimeFactory):
    DEFAULT_ID = "default"

    def __init__(self, default_factory: DataObjectFactory,
                 registry_entries: Optional[List[DataObjectFactory]] = None):
        super().__init__([default_factory, *(registry_entries or [])])
        self.default_factory = default_factory

    def instantiate_first_time(self, container) -> None:
        obj = self.default_factory.create_instance(container.runtime,
                                                   self.DEFAULT_ID)
        self._container_instances(container)[self.DEFAULT_ID] = obj

    def instantiate_from_existing(self, container) -> None:
        obj = self.default_factory.load_instance(container.runtime,
                                                 self.DEFAULT_ID)
        self._container_instances(container)[self.DEFAULT_ID] = obj

    def get_default_object(self, container) -> PureDataObject:
        return self._container_instances(container)[self.DEFAULT_ID]

    def request(self, container, url: str = "/"):
        parser = RequestParser(url)
        if not parser.path_parts:
            return self.get_default_object(container)
        return super().request(container, url)

    # -- sugar: create or load a container and hand back the default object
    def create_detached(self, loader, document_id: str):
        container = loader.create_detached(document_id)
        self.initialize(container, existing=False)
        return container, self.get_default_object(container)

    def load(self, loader, document_id: str):
        container = loader.resolve(document_id)
        self.initialize(container, existing=True)
        return container, self.get_default_object(container)
