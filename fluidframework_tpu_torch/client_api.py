"""Legacy `Document` facade.

Capability parity with reference packages/runtime/client-api/src (662 LoC,
`document.ts`): the old flat API from before the aqueduct era — one
Document object wrapping a container, with a root SharedDirectory and
typed `create*` helpers. Kept for the same reason the reference keeps it:
existing callers and tools (e.g. replay pipelines) speak this shape.

A port of fluidframework_tpu's client_api.py: `create` and `load` build
their Loader on `device` (None means "cuda", which raises without CUDA).
"""

from __future__ import annotations

import itertools
from typing import Optional

from .dds.cell import SharedCell
from .dds.counter import SharedCounter
from .dds.directory import SharedDirectory
from .dds.ink import Ink
from .dds.map import SharedMap
from .dds.matrix import SharedMatrix
from .dds.sequence import (SharedNumberSequence, SharedObjectSequence,
                           SharedString)
from .loader.container import Container, Loader
from .loader.drivers.base import IDocumentServiceFactory

_uid = itertools.count(1)

ROOT_STORE = "client-api"
ROOT_CHANNEL = "root"


class Document:
    """The legacy facade. Events pass through from the container."""

    def __init__(self, container: Container, existing: bool):
        self.container = container
        self.existing = existing
        self.runtime = container.runtime
        self._store = (container.runtime.get_datastore(ROOT_STORE)
                       if existing else None)

    # -- lifecycle ---------------------------------------------------------
    @staticmethod
    def create(document_id: str, service_factory: IDocumentServiceFactory,
               device=None) -> "Document":
        loader = Loader(service_factory, device=device)
        container = loader.create_detached(document_id)
        store = container.runtime.create_datastore(ROOT_STORE)
        store.create_channel(ROOT_CHANNEL, SharedDirectory.TYPE)
        container.attach()
        doc = Document(container, existing=False)
        doc._store = store
        return doc

    @staticmethod
    def load(document_id: str, service_factory: IDocumentServiceFactory,
             device=None) -> "Document":
        loader = Loader(service_factory, device=device)
        return Document(loader.resolve(document_id), existing=True)

    @property
    def id(self) -> str:
        return self.container.document_id

    @property
    def client_id(self) -> Optional[str]:
        return self.container.delta_manager.client_id

    def on(self, event: str, fn) -> None:
        self.container.on(event, fn)

    def off(self, event: str, fn) -> None:
        self.container.off(event, fn)

    def close(self) -> None:
        self.container.close()

    # -- root + creation helpers (document.ts getRoot/create*) -------------
    def get_root(self) -> SharedDirectory:
        return self._store.get_channel(ROOT_CHANNEL)

    def _create(self, dds_type: str, object_id: Optional[str]):
        object_id = object_id or f"{dds_type.rsplit('/', 1)[-1]}-{next(_uid)}"
        return self._store.create_channel(object_id, dds_type)

    def create_map(self, object_id: Optional[str] = None) -> SharedMap:
        return self._create(SharedMap.TYPE, object_id)

    def create_directory(self, object_id: Optional[str] = None
                         ) -> SharedDirectory:
        return self._create(SharedDirectory.TYPE, object_id)

    def create_string(self, object_id: Optional[str] = None) -> SharedString:
        return self._create(SharedString.TYPE, object_id)

    def create_cell(self, object_id: Optional[str] = None) -> SharedCell:
        return self._create(SharedCell.TYPE, object_id)

    def create_counter(self, object_id: Optional[str] = None) -> SharedCounter:
        return self._create(SharedCounter.TYPE, object_id)

    def create_stream(self, object_id: Optional[str] = None) -> Ink:
        # The reference's createStream returns the ink stream DDS.
        return self._create(Ink.TYPE, object_id)

    def create_matrix(self, object_id: Optional[str] = None) -> SharedMatrix:
        return self._create(SharedMatrix.TYPE, object_id)

    def create_number_sequence(self, object_id: Optional[str] = None
                               ) -> SharedNumberSequence:
        return self._create(SharedNumberSequence.TYPE, object_id)

    def create_object_sequence(self, object_id: Optional[str] = None
                               ) -> SharedObjectSequence:
        return self._create(SharedObjectSequence.TYPE, object_id)

    def get(self, object_id: str):
        """Fetch an existing channel by id (document.ts get)."""
        return self._store.get_channel(object_id)
