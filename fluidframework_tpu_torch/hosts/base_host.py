"""BaseHost: application-side glue over Loader + CodeLoader.

Capability parity with reference packages/hosts/base-host/src (647 LoC:
`BaseHost.initializeContainer` / `getFluidObjectFromContainer`): a host
owns the service connection and the code registry, creates or loads
containers, and resolves URLs/paths to the data objects inside them. The
reference also reacts to quorum "code" upgrades by reloading the page;
here `on_code_change` re-resolves the container for the caller.

A port of fluidframework_tpu's hosts/base_host.py: the host's Loader, and
so every container it opens, runs on `device` (None means "cuda", which
raises without CUDA; tests pass "cpu").
"""

from __future__ import annotations

from typing import Callable, Optional

from ..loader.code_loader import CodeLoader
from ..loader.container import Container, Loader
from ..loader.drivers.base import IDocumentServiceFactory
from ..runtime.datastore_runtime import ChannelRegistry


class BaseHost:
    def __init__(self, service_factory: IDocumentServiceFactory,
                 code_loader: CodeLoader,
                 code_details: Optional[dict] = None,
                 registry: Optional[ChannelRegistry] = None,
                 device=None):
        self.loader = Loader(service_factory, registry,
                             code_loader=code_loader,
                             code_details=code_details, device=device)

    # -- containers --------------------------------------------------------
    def initialize_container(self, document_id: str,
                             code_details: Optional[dict] = None
                             ) -> Container:
        """Create-if-absent (reference initializeContainer): load the
        document, or create + attach it with the given code details."""
        try:
            return self.loader.resolve(document_id)
        except FileNotFoundError:
            container = self.loader.create_detached(document_id, code_details)
            container.attach()
            return container

    # -- object resolution -------------------------------------------------
    def get_fluid_object(self, document_id: str, path: str = "/"):
        """Resolve a document + path to a data object (reference
        getFluidObjectFromContainer)."""
        container = self.initialize_container(document_id)
        return container.request(path)

    def on_code_change(self, container: Container,
                       reload: Callable[[Container], None]) -> None:
        """Invoke `reload` with a freshly loaded container whenever a quorum
        code upgrade is approved (the reference's page-reload path)."""
        container.on(
            "codeChanged",
            lambda details: reload(self.loader.resolve(container.document_id)))
