"""Lazy-loaded data objects.

Capability parity with reference packages/framework/data-object-base
(`lazyLoadedDataObject.ts`, `lazyLoadedDataObjectFactory.ts`): a data
object whose expensive initialization (channel realization, view setup) is
deferred until first use — the container loads its summary without paying
for stores nobody has requested yet (the reference's lazy
FluidDataStoreContext.realize analog at the framework layer).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .data_object import DataObjectFactory, PureDataObject


class LazyLoadedDataObject(PureDataObject):
    """Subclasses implement `realize()` (first-use init) instead of the
    eager initializing hooks. `instance()` triggers realization."""

    def __init__(self, store):
        super().__init__(store)
        self._realized = False

    def realize(self) -> None:
        """First-use initialization hook."""

    def instance(self) -> "LazyLoadedDataObject":
        if not self._realized:
            self._realized = True
            self.realize()
        return self

    @property
    def realized(self) -> bool:
        return self._realized


class LazyLoadedDataObjectFactory(DataObjectFactory):
    """Creates the store eagerly (it must exist in the summary) but defers
    the data object's realize() until the first `get`."""

    def __init__(self, type_name: str, data_object_class=LazyLoadedDataObject):
        super().__init__(type_name, data_object_class)
        self._cache: dict = {}

    def get(self, container_runtime, store_id: str) -> LazyLoadedDataObject:
        key = (id(container_runtime), store_id)
        if key not in self._cache:
            obj = self.data_object_class(
                container_runtime.get_datastore(store_id))
            self._cache[key] = obj
        return self._cache[key].instance()
