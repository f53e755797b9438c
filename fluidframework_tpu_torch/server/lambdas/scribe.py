"""Scribe: the server-side summary writer.

A copy of fluidframework_tpu's server/lambdas/scribe.py, host code that
the port keeps as its own.

Capability parity with reference lambdas/src/scribe/lambda.ts:40-192 — runs
a ProtocolOpHandler replica over the sequenced stream, and on a client
Summarize op validates + commits the uploaded summary to git storage, then
emits summaryAck (or summaryNack) back through the sequencer. Also persists
its own protocol-state checkpoints so a restart resumes mid-stream.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional

from ...protocol.messages import DocumentMessage, MessageType, \
    SequencedDocumentMessage
from ...protocol.protocol_handler import ProtocolOpHandler, ProtocolState
from ...telemetry import tracing
from ...telemetry import watermarks
from ...telemetry.counters import increment, record_swallow
from ..database import Collection
from ..log import QueuedMessage
from ..storage import GitStore, Historian
from .base import IPartitionLambda, LambdaContext


class ScribeLambda(IPartitionLambda):
    def __init__(self, context: LambdaContext, historian: Historian,
                 tenant_id: str,
                 send_system: Callable[[str, DocumentMessage], None],
                 checkpoints: Optional[Collection] = None,
                 fresh_log: bool = False,
                 on_commit: Optional[Callable[[str, str], None]] = None):
        """send_system(document_id, message) routes summaryAck/Nack back
        through deli for sequencing. fresh_log: see DeliLambda — True when
        consuming a new MessageLog with checkpoints handed over from a
        previous core (takeover), False for same-log crash-restart.
        on_commit(document_id, commit_sha): fired after a validated
        summary advances the ref — cache-tier invalidation rides this."""
        self.context = context
        self.historian = historian
        self.tenant_id = tenant_id
        self.send_system = send_system
        self.on_commit = on_commit
        self.checkpoints = checkpoints
        self.handlers: Dict[str, ProtocolOpHandler] = {}
        self.log_offsets: Dict[str, int] = {}
        if checkpoints is not None:
            # Crash restart resumes each document's protocol replica from
            # its checkpoint (duplicate sequenced ops replay as no-ops).
            for row in checkpoints.find(lambda d: "documentId" in d):
                self.load_checkpoint(row["documentId"], row)
                if fresh_log:
                    self.log_offsets[row["documentId"]] = -1

    def handler(self, message: QueuedMessage) -> None:
        value = message.value
        if hasattr(value, "messages"):
            # SequencedWindow: one record per flush; process per message
            # with the same per-document replay guard, checkpoint each
            # touched document once at the end.
            touched = set()
            for doc_id, sequenced in value.messages():
                if message.offset <= self.log_offsets.get(doc_id, -1):
                    continue
                handler = self.handlers.setdefault(doc_id,
                                                   ProtocolOpHandler())
                handler.process_message(sequenced)
                if sequenced.type == MessageType.SUMMARIZE:
                    self._handle_summarize(doc_id, sequenced)
                touched.add(doc_id)
            for doc_id in touched:
                self.log_offsets[doc_id] = message.offset
                self._checkpoint_doc(doc_id, message.offset)
            self.context.checkpoint(message.offset)
            return
        doc_id, sequenced = value
        if message.offset <= self.log_offsets.get(doc_id, -1):
            return  # replayed message already handled (mirrors deli's guard)
        handler = self.handlers.setdefault(doc_id, ProtocolOpHandler())
        handler.process_message(sequenced)
        if sequenced.type == MessageType.SUMMARIZE:
            self._handle_summarize(doc_id, sequenced)
        self.log_offsets[doc_id] = message.offset
        self.context.checkpoint(message.offset)
        self._checkpoint_doc(doc_id, message.offset)

    def _checkpoint_doc(self, doc_id: str, offset: int) -> None:
        if self.checkpoints is None:
            return
        snap = self.handlers[doc_id].snapshot()
        self.checkpoints.upsert(
            lambda d, _id=doc_id: d.get("documentId") == _id,
            {"documentId": doc_id,
             "sequenceNumber": snap.sequence_number,
             "minimumSequenceNumber": snap.minimum_sequence_number,
             "quorum": snap.quorum_snapshot,
             "logOffset": offset})

    def _handle_summarize(self, doc_id: str,
                          sequenced: SequencedDocumentMessage) -> None:
        # Summaries are rare and load-bearing: root a trace even when the
        # proposing client didn't carry one (root=True head-samples).
        with tracing.span("scribe.summarize",
                          parent=tracing.message_context(sequenced),
                          root=True, hist="scribe.summarize",
                          document=doc_id):
            self._handle_summarize_inner(doc_id, sequenced)

    def _handle_summarize_inner(self, doc_id: str,
                                sequenced: SequencedDocumentMessage
                                ) -> None:
        contents = sequenced.contents
        if isinstance(contents, str):
            contents = json.loads(contents)
        store = self.historian.store(self.tenant_id, doc_id)
        commit_sha = contents.get("handle")
        commit = store.get(commit_sha) if commit_sha else None
        if commit is None:
            nack = DocumentMessage(
                client_sequence_number=0,
                reference_sequence_number=sequenced.sequence_number,
                type=MessageType.SUMMARY_NACK,
                contents={"summaryProposal": {
                    "summarySequenceNumber": sequenced.sequence_number},
                    "errorMessage": f"unknown summary commit {commit_sha!r}"})
            tracing.stamp_message(nack, tracing.current()
                                  or tracing.root_context())
            self.send_system(doc_id, nack)
            return
        # Valid: advance the main ref and ack with the commit handle.
        store.set_ref("main", commit_sha)
        # Commit rate beside the summarize.* extraction counters: an
        # incremental-summary regression shows up as bytes/commit (or
        # blob-cache hit rate) drifting, not as a single number.
        increment("summarize.commits")
        # `summarized` watermark: ops up to the proposal's seq are now
        # covered by a committed summary (replay folds to zero).
        watermarks.advance_doc(watermarks.SUMMARIZED,
                               getattr(self.context, "partition", 0),
                               doc_id, sequenced.sequence_number)
        if self.on_commit is not None:
            try:
                self.on_commit(doc_id, commit_sha)
            except Exception:  # noqa: BLE001 — observers never break scribe
                record_swallow("scribe.commit_observer")
        ack = DocumentMessage(
            client_sequence_number=0,
            reference_sequence_number=sequenced.sequence_number,
            type=MessageType.SUMMARY_ACK,
            contents={"handle": commit_sha, "summaryProposal": {
                "summarySequenceNumber": sequenced.sequence_number}})
        # The ack re-enters the raw log as a system message: carry the
        # summarize span's context (or a fresh root) so the round trip
        # stays one joined timeline instead of going dark at the ack.
        tracing.stamp_message(ack, tracing.current()
                              or tracing.root_context())
        self.send_system(doc_id, ack)

    def load_checkpoint(self, doc_id: str, dump: dict) -> None:
        self.handlers[doc_id] = ProtocolOpHandler.load(ProtocolState(
            sequence_number=dump["sequenceNumber"],
            minimum_sequence_number=dump["minimumSequenceNumber"],
            quorum_snapshot=dump["quorum"]))
        self.log_offsets[doc_id] = dump.get("logOffset", -1)
