"""Local driver: the in-process driver onto LocalServer (reference
packages/drivers/local-driver — the test backbone, SURVEY.md §2.3).

A port of fluidframework_tpu's loader/drivers/local.py over this
package's own LocalServer / TpuLocalServer (server/local_server.py).
"""

from __future__ import annotations

from typing import List, Optional

from ...protocol.messages import ITrace, SequencedDocumentMessage
from ...protocol.summary import SummaryTree
from ...server.local_server import LocalServer
from ...telemetry import tracing
from .base import (
    IDocumentDeltaConnection,
    IDocumentDeltaStorageService,
    IDocumentService,
    IDocumentServiceFactory,
    IDocumentStorageService,
)


def _row_to_message(row: dict) -> SequencedDocumentMessage:
    return SequencedDocumentMessage(
        client_id=row["client_id"],
        sequence_number=row["sequence_number"],
        minimum_sequence_number=row["minimum_sequence_number"],
        client_sequence_number=row["client_sequence_number"],
        reference_sequence_number=row["reference_sequence_number"],
        type=row["type"],
        contents=row["contents"],
        metadata=row.get("metadata"),
        server_metadata=row.get("server_metadata"),
        timestamp=row.get("timestamp", 0.0),
        traces=[ITrace(**t) if isinstance(t, dict) else t
                for t in row.get("traces", [])],
        data=row.get("data"),
    )


class LocalDocumentStorageService(IDocumentStorageService):
    def __init__(self, server: LocalServer, document_id: str):
        self.server = server
        self.document_id = document_id
        self.store = server.storage(document_id)

    def get_summary(self, version: Optional[str] = None):
        # Reads ride the historian cache (reference: drivers talk to
        # historian, the caching proxy, never to gitrest directly).
        # lazy: blob contents resolve on first access, so a lazy-loading
        # channel (sequence body chunks) defers their transfer entirely.
        return self.server.historian.read_summary(
            self.server.tenant_id, self.document_id, commit_sha=version,
            lazy=True)

    def upload_summary(self, summary: SummaryTree,
                       parent: Optional[str] = None,
                       initial: bool = False) -> str:
        """initial=True is the attach summary: it becomes the load target
        immediately (no scribe in the loop yet). Later uploads are proposals;
        scribe advances the ref on summaryAck."""
        return self.store.write_summary(summary, base_commit=parent,
                                        advance_ref=initial)

    def get_versions(self, count: int = 1) -> List[str]:
        return [c.sha for c in self.store.list_commits(limit=count)]

    def get_catchup(self):
        """summary + delta in one call (in-process, so the `one round
        trip` is literal: both halves resolve against the same server
        under one lock round)."""
        artifact = self.server.get_catchup(self.document_id)
        summary = None
        if artifact is not None and artifact.get("summarySha"):
            # Load the EXACT summary the artifact was published against:
            # a client summary committed after the refresh would
            # otherwise race ahead of the delta's baseline.
            summary = self.server.historian.read_summary(
                self.server.tenant_id, self.document_id,
                commit_sha=artifact["summarySha"], lazy=True)
        if summary is None:
            summary = self.get_summary()
        return summary, artifact

    def get_catchup_artifact(self):
        return self.server.get_catchup(self.document_id)


class LocalDeltaStorageService(IDocumentDeltaStorageService):
    def __init__(self, server: LocalServer, document_id: str):
        self.server = server
        self.document_id = document_id

    def get(self, from_seq: int, to_seq: Optional[int] = None
            ) -> List[SequencedDocumentMessage]:
        rows = self.server.get_deltas(self.document_id, from_seq, to_seq)
        return [_row_to_message(r) for r in rows]


class LocalDocumentDeltaConnection(IDocumentDeltaConnection):
    def __init__(self, server: LocalServer, document_id: str,
                 client_details: Optional[dict]):
        self._conn = server.connect(document_id, client_details)
        self.client_id = self._conn.client_id

    def submit(self, messages) -> None:
        # Adopt the context the client edit minted (same thread) — or
        # mint one here — and put it on the wire: metadata rides the
        # envelope end to end.
        ctx = tracing.ensure_op_context()
        if ctx is not None:
            for msg in messages:
                tracing.stamp_message(msg, ctx)
        with tracing.span("driver.submit", parent=ctx,
                          count=len(messages)):
            self._conn.submit(messages)

    def submit_signal(self, content) -> None:
        self._conn.submit_signal(content)

    def on(self, event, fn) -> None:
        self._conn.on(event, fn)

    def off(self, event, fn) -> None:
        self._conn.off(event, fn)

    def close(self) -> None:
        self._conn.disconnect()


class LocalDocumentService(IDocumentService):
    def __init__(self, server: LocalServer, document_id: str):
        self.server = server
        self.document_id = document_id

    def connect_to_storage(self):
        return LocalDocumentStorageService(self.server, self.document_id)

    def connect_to_delta_storage(self):
        return LocalDeltaStorageService(self.server, self.document_id)

    def connect_to_delta_stream(self, client_details=None):
        return LocalDocumentDeltaConnection(self.server, self.document_id,
                                            client_details)


class LocalDocumentServiceFactory(IDocumentServiceFactory):
    def __init__(self, server: LocalServer):
        self.server = server

    def create_document_service(self, document_id: str) -> IDocumentService:
        return LocalDocumentService(self.server, document_id)
