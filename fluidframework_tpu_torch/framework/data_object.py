"""Aqueduct data objects: the developer-facing sugar over runtime + DDS.

Capability parity with reference packages/framework/aqueduct/src/
data-objects/{pureDataObject.ts:46, dataObject.ts:34} and
data-object-factories: a DataObject owns one datastore, exposes a root
SharedDirectory, and runs the initializingFirstTime / initializingFromExisting
/ hasInitialized lifecycle exactly once per in-memory instance.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

from ..core.events import TypedEventEmitter
from ..dds.directory import SharedDirectory
from ..dds.shared_object import FluidHandle
from ..runtime.datastore_runtime import DataStoreRuntime


class PureDataObject(TypedEventEmitter):
    """Base component with the init lifecycle but no mandated root DDS."""

    def __init__(self, store: DataStoreRuntime):
        super().__init__()
        self.store = store
        self._initialized = False

    @property
    def id(self) -> str:
        return self.store.id

    @property
    def handle(self) -> FluidHandle:
        return FluidHandle(f"/{self.store.id}", self)

    @property
    def runtime(self):
        return self.store.container

    # -- lifecycle (subclass hooks) ----------------------------------------
    def initialize(self, existing: bool) -> None:
        if self._initialized:
            return
        self._initialized = True
        if existing:
            self.initializing_from_existing()
        else:
            self.initializing_first_time()
        self.has_initialized()

    def initializing_first_time(self) -> None:
        """Create-time setup: build channels, seed initial state."""

    def initializing_from_existing(self) -> None:
        """Load-time setup: grab existing channels."""

    def has_initialized(self) -> None:
        """Runs after either path: wire event listeners etc."""


class DataObject(PureDataObject):
    """PureDataObject + a root SharedDirectory (dataObject.ts:34)."""

    ROOT_ID = "root"

    def __init__(self, store: DataStoreRuntime):
        super().__init__(store)
        self._root: Optional[SharedDirectory] = None

    @property
    def root(self) -> SharedDirectory:
        assert self._root is not None, "not initialized"
        return self._root

    def initialize(self, existing: bool) -> None:
        if not self._initialized:
            if existing:
                self._root = self.store.get_channel(self.ROOT_ID)
            else:
                self._root = self.store.create_channel(self.ROOT_ID,
                                                       SharedDirectory.TYPE)
        super().initialize(existing)


class DataObjectFactory:
    """Creates/loads DataObject instances over datastores
    (reference aqueduct DataObjectFactory)."""

    def __init__(self, type_name: str,
                 data_object_class: Type[PureDataObject]):
        self.type = type_name
        self.data_object_class = data_object_class

    def create_instance(self, container_runtime, store_id: str,
                        root: bool = True) -> PureDataObject:
        store = container_runtime.create_datastore(store_id, root=root)
        obj = self.data_object_class(store)
        obj.initialize(existing=False)
        return obj

    def load_instance(self, container_runtime, store_id: str
                      ) -> PureDataObject:
        store = container_runtime.get_datastore(store_id)
        obj = self.data_object_class(store)
        obj.initialize(existing=True)
        return obj
