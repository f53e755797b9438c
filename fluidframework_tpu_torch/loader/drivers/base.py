"""Driver SPI (reference packages/loader/driver-definitions/src/storage.ts:
30-259): the service abstraction the loader consumes. A driver provides
storage (summaries/blobs), delta storage (catch-up reads), and a delta
connection (live op stream) for one document.

A port of fluidframework_tpu's loader/drivers/base.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from ...protocol.messages import DocumentMessage, SequencedDocumentMessage
from ...protocol.summary import SummaryTree


class IDocumentStorageService:
    def get_summary(self, version: Optional[str] = None
                    ) -> Optional[SummaryTree]:
        raise NotImplementedError

    def upload_summary(self, summary: SummaryTree,
                       parent: Optional[str] = None,
                       initial: bool = False) -> str:
        """Returns the storage handle (commit sha) for a summarize op.
        initial=True marks the attach summary, which becomes the load
        target directly; other uploads await a scribe summaryAck."""
        raise NotImplementedError

    def get_versions(self, count: int = 1) -> List[str]:
        raise NotImplementedError

    def get_catchup(self):
        """`summary + delta` in one round trip (docs/read_path.md):
        returns (summary_tree, catchup_artifact_or_None). The artifact is
        the serving tier's per-doc incremental catch-up state
        (server/readpath.py); drivers without a read tier return the
        summary with None and the loader tail-replays — the always-
        correct fallback this default encodes."""
        return self.get_summary(), None

    def get_catchup_artifact(self):
        """Artifact-only fetch (the reconnect path: the client already
        holds a summary-derived state and only wants the delta)."""
        return None


class IDocumentDeltaStorageService:
    def get(self, from_seq: int, to_seq: Optional[int] = None
            ) -> List[SequencedDocumentMessage]:
        raise NotImplementedError


class IDocumentDeltaConnection:
    """Live connection: .client_id, .submit(), .submit_signal(), events via
    .on('op'|'nack'|'signal'|'disconnect', fn), .close()."""

    client_id: str

    def submit(self, messages: List[DocumentMessage]) -> None:
        raise NotImplementedError

    def submit_signal(self, content: Any) -> None:
        """Transient broadcast to the document's room; bypasses sequencing
        (reference IDocumentDeltaConnection.submitSignal). Read-only
        connections (replay/file) reject it."""
        raise NotImplementedError

    def on(self, event: str, fn: Callable) -> None:
        raise NotImplementedError

    def off(self, event: str, fn: Callable) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class IDocumentService:
    def connect_to_storage(self) -> IDocumentStorageService:
        raise NotImplementedError

    def connect_to_delta_storage(self) -> IDocumentDeltaStorageService:
        raise NotImplementedError

    def connect_to_delta_stream(self, client_details: Optional[dict] = None
                                ) -> IDocumentDeltaConnection:
        raise NotImplementedError


class IDocumentServiceFactory:
    def create_document_service(self, document_id: str) -> IDocumentService:
        raise NotImplementedError
