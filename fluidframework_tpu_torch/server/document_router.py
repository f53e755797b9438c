"""Document router: per-document sub-partitioning of one log partition.

Capability parity with reference lambdas-driver/src/document-router/
(`documentLambda.ts`, `documentPartition.ts`, `documentContext.ts`,
`contextManager.ts`; design in kafka-service/README.md:52-56): a partition
carries many documents' messages interleaved; the router fans each message
out to a per-document lambda with its own *virtual* checkpoint context, and
consolidates those per-document checkpoints into the one real partition
offset — committed only up to the point every document has durably
processed, so a crash replays exactly the uncheckpointed suffix for every
document (idempotent handlers absorb the overlap).

TPU mapping (SURVEY.md §2.6.2): the per-document lanes here are the host-
side routing shape; inside the fused pipeline the same documents form the
batch axis of the ticket/apply kernels.

A port of fluidframework_tpu's server/document_router.py over this
package's lambdas/base.py and log.py.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from .lambdas.base import IPartitionLambda, LambdaContext
from .log import QueuedMessage


class DocumentContext:
    """The checkpoint surface handed to one document's lambda (reference
    documentContext.ts): tracks the highest offset routed to the document
    (`tail`) and the highest offset its lambda has declared durable
    (`checkpointed`)."""

    def __init__(self, manager: "DocumentContextManager"):
        self._manager = manager
        self.tail = -1          # last offset routed to this document
        self.checkpointed = -1  # last offset the doc lambda checkpointed

    @property
    def pending(self) -> bool:
        return self.checkpointed < self.tail

    def checkpoint(self, offset: int) -> None:
        if offset > self.checkpointed:
            self.checkpointed = min(offset, self.tail)
            self._manager.update()

    def error(self, err: Exception, restart: bool) -> None:
        self._manager.error(err, restart)


class DocumentContextManager:
    """Consolidates per-document checkpoints into the real partition offset
    (reference contextManager.ts): the partition may commit up to
    min(checkpointed over documents still pending, else the global head)."""

    def __init__(self, context: LambdaContext):
        self.context = context
        self.contexts: Dict[str, DocumentContext] = {}
        self.head = -1       # last offset routed to any document
        self._committed = -1

    def create_context(self, doc_id: str) -> DocumentContext:
        ctx = DocumentContext(self)
        self.contexts[doc_id] = ctx
        return ctx

    def track(self, doc_id: str, offset: int) -> DocumentContext:
        ctx = self.contexts.get(doc_id)
        if ctx is None:
            ctx = self.create_context(doc_id)
        ctx.tail = offset
        self.head = max(self.head, offset)
        return ctx

    def safe_offset(self) -> int:
        pending = [c.checkpointed for c in self.contexts.values() if c.pending]
        if not pending:
            return self.head
        return min(pending)

    def update(self) -> None:
        safe = self.safe_offset()
        if safe > self._committed:
            self._committed = safe
            self.context.checkpoint(safe)

    def error(self, err: Exception, restart: bool) -> None:
        self.context.error(err, restart)


class DocumentRouterLambda(IPartitionLambda):
    """The routing lambda itself (reference documentLambda.ts). Document
    identity comes from the message key (the log already partitions by it).

    A per-document lambda crash marks that document corrupt and stops
    routing to it (reference documentPartition.ts: "Close" the partition on
    error) while other documents keep flowing; the error still surfaces
    through the real context so the host can decide to restart the stage.
    """

    def __init__(self, context: LambdaContext,
                 document_lambda_factory: Callable[
                     [str, DocumentContext], IPartitionLambda]):
        self.context = context
        self.manager = DocumentContextManager(context)
        self.factory = document_lambda_factory
        self.documents: Dict[str, IPartitionLambda] = {}
        self.corrupt: Dict[str, Exception] = {}

    def handler(self, message: QueuedMessage) -> None:
        doc_id = message.key
        if doc_id in self.corrupt:
            # Skip but keep the checkpoint frontier moving: a dead document
            # must not pin the partition offset forever.
            ctx = self.manager.track(doc_id, message.offset)
            ctx.checkpoint(message.offset)
            return
        ctx = self.manager.track(doc_id, message.offset)
        doc_lambda = self.documents.get(doc_id)
        if doc_lambda is None:
            doc_lambda = self.factory(doc_id, ctx)
            self.documents[doc_id] = doc_lambda
        try:
            doc_lambda.handler(message)
        except Exception as err:  # noqa: BLE001 — per-doc crash isolation
            self.corrupt[doc_id] = err
            ctx.checkpoint(message.offset)
            self.manager.error(err, restart=False)

    def close(self) -> None:
        for doc_lambda in self.documents.values():
            doc_lambda.close()
        self.documents.clear()

    # -- introspection ------------------------------------------------------
    def document_ids(self) -> list:
        return list(self.documents)

    def reap_idle(self, keep: Optional[set] = None) -> int:
        """Drop fully-checkpointed document lambdas (reference
        documentPartition inactivity timeout): safe because their state
        reloads from checkpoints on the next message."""
        keep = keep or set()
        reaped = 0
        for doc_id in list(self.documents):
            ctx = self.manager.contexts.get(doc_id)
            if doc_id not in keep and ctx is not None and not ctx.pending:
                self.documents.pop(doc_id).close()
                del self.manager.contexts[doc_id]
                reaped += 1
        return reaped
