"""Deli: the sequencer lambda.

A copy of fluidframework_tpu's server/lambdas/deli.py, host code that the
port keeps as its own.

Capability parity with reference lambdas/src/deli/lambda.ts:82-224 — assign
sequenceNumber + minimumSequenceNumber per document (min over per-client
refSeqs), nack stale refSeqs, drop duplicate clientSeqs, manage client
join/leave, emit NoClient when the document empties, and checkpoint state.

Two execution paths share the semantics:
- this host lambda: per-op, for the interactive local-server path;
- server/ticket_kernel.py: the batched device kernel the partition host
  uses to ticket whole [B, T] op blocks in one kernel launch (the device
  "boxcar").
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ...protocol.messages import (
    Boxcar,
    DocumentMessage,
    ITrace,
    MessageType,
    Nack,
    NackContent,
    NACK_BAD_REF_SEQ,
    SequencedDocumentMessage,
)
from ...telemetry import tracing
from ..log import QueuedMessage
from .base import IPartitionLambda, LambdaContext


@dataclass
class ClientSeqState:
    """Per-client sequencing entry (reference clientSeqManager.ts)."""

    client_id: str
    ref_seq: int
    client_seq: int
    can_evict: bool = True
    last_update: float = field(default_factory=time.time)


@dataclass
class DeliCheckpoint:
    sequence_number: int
    minimum_sequence_number: int
    log_offset: int
    clients: List[dict]


class DocumentDeliState:
    def __init__(self, sequence_number: int = 0,
                 minimum_sequence_number: int = 0, log_offset: int = -1):
        self.sequence_number = sequence_number
        self.minimum_sequence_number = minimum_sequence_number
        self.log_offset = log_offset
        self.clients: Dict[str, ClientSeqState] = {}

    def msn(self) -> int:
        refs = [c.ref_seq for c in self.clients.values()]
        if not refs:
            return self.minimum_sequence_number
        return max(self.minimum_sequence_number, min(refs))


class DeliLambda(IPartitionLambda):
    def __init__(self, context: LambdaContext,
                 emit: Callable[[str, SequencedDocumentMessage], None],
                 nack: Callable[[str, str, Nack], None],
                 checkpoints=None, fresh_log: bool = False,
                 config=None, send_system=None):
        """emit(document_id, sequenced_message); nack(document_id,
        client_id, nack). checkpoints: optional Collection for state dumps —
        restored at construction so a crash-restarted lambda resumes from
        its last checkpoint instead of re-sequencing from zero.

        fresh_log=True when this lambda consumes a brand-new MessageLog
        (multi-node takeover hands over checkpointed deli state, not the
        log): checkpointed offsets index the previous core's log, so replay
        protection must not skip the new log's messages. False (default) is
        the same-log crash-restart, where the checkpointed offset is the
        replay guard."""
        self.context = context
        self.emit = emit
        self.nack = nack
        self.docs: Dict[str, DocumentDeliState] = {}
        self.checkpoints = checkpoints
        # Batched checkpointing (reference deli/checkpointContext.ts with
        # checkpointBatchSize / checkpointTimeIntervalMsec from the nconf
        # config, routerlicious/config/config.json:62-68): the state dump
        # AND the offset commit move together — committing an offset beyond
        # the saved state would shrink the crash-replay window below what
        # the state needs. Default batch size 1 = checkpoint every message.
        self.checkpoint_batch_size = 1
        self.checkpoint_interval_s = 0.0
        if config is not None:
            self.checkpoint_batch_size = int(config.get(
                "deli.checkpointBatchSize", 1))
            self.checkpoint_interval_s = float(config.get(
                "deli.checkpointTimeIntervalMsec", 0)) / 1000.0
        self._uncheckpointed = 0
        self._last_checkpoint_time = time.monotonic()
        self._pending_offset: Optional[int] = None
        # Ghost-client eviction (reference ClientSequenceTimeout,
        # clientSeqManager canEvict): a writer that crashes without a
        # leave op would pin the MSN forever; after clientTimeout of
        # silence the sequencer synthesizes its leave. 0 disables.
        # The leave is SENT INTO THE RAW LOG (send_system) rather than
        # ticketed in place: sequencing inputs must all ride the log, or
        # a crash-replay would re-derive different sequence numbers than
        # the ones already broadcast (wall clock is not replayable).
        self.send_system = send_system
        self._evicting: Dict[str, set] = {}  # doc -> in-flight evictions
        self.client_timeout_s = 300.0
        if config is not None:
            self.client_timeout_s = float(config.get(
                "deli.clientTimeoutMsec", 300_000)) / 1000.0
        if checkpoints is not None:
            for row in checkpoints.find(lambda d: "documentId" in d):
                if row.get("handedOff") or "state" not in row:
                    # Rebalance tombstone (export_doc/drop_doc): this
                    # partition handed the document to another owner —
                    # restoring it here would re-adopt a moved document.
                    continue
                state = self.load_state(row["state"])
                if fresh_log:
                    state.log_offset = -1
                self.docs[row["documentId"]] = state

    # -- lambda ------------------------------------------------------------
    def handler(self, message: QueuedMessage) -> None:
        if isinstance(message.value, (bytes, bytearray)):
            from ..wire import boxcar_from_wire
            message = QueuedMessage(
                topic=message.topic, partition=message.partition,
                offset=message.offset, key=message.key,
                value=boxcar_from_wire(message.value))
        boxcar: Boxcar = message.value
        doc_id = boxcar.document_id
        state = self.docs.setdefault(doc_id, DocumentDeliState())
        if message.offset <= state.log_offset:
            return  # replayed message already processed (deli/lambda.ts:143)
        for raw in boxcar.contents:
            ctx = tracing.message_context(raw)
            if ctx is None:
                self._ticket(doc_id, state, boxcar.client_id, raw)
            else:
                with tracing.span("deli.ticket", parent=ctx,
                                  document=doc_id):
                    self._ticket(doc_id, state, boxcar.client_id, raw)
        self._evict_ghosts(doc_id, state)
        state.log_offset = message.offset
        self._pending_offset = message.offset
        self._uncheckpointed += 1
        now = time.monotonic()
        due = (self._uncheckpointed >= self.checkpoint_batch_size
               or (self.checkpoint_interval_s
                   and now - self._last_checkpoint_time
                   >= self.checkpoint_interval_s))
        if due:
            self.flush_checkpoint()

    def flush_checkpoint(self) -> None:
        """Write all document states + commit the consumer offset."""
        if self._pending_offset is None:
            return
        if self.checkpoints is not None:
            for doc_id, state in self.docs.items():
                self.checkpoints.upsert(
                    lambda d, _id=doc_id: d.get("documentId") == _id,
                    {"documentId": doc_id, "state": self._dump(state)})
        self.context.checkpoint(self._pending_offset)
        self._pending_offset = None
        self._uncheckpointed = 0
        self._last_checkpoint_time = time.monotonic()

    def close(self) -> None:
        # Graceful close flushes; a crash (no close) replays the batch —
        # exactly the reference's at-least-once window.
        self.flush_checkpoint()

    def doc_sequence_numbers(self) -> Dict[str, int]:
        """Per-document head sequence number: the `ticketed` watermark
        feed (telemetry/watermarks.py). Pulled at scrape time by the
        sharding tier, never per op."""
        return {doc_id: state.sequence_number
                for doc_id, state in self.docs.items()}

    def _dump(self, state: DocumentDeliState) -> dict:
        return {
            "sequenceNumber": state.sequence_number,
            "minimumSequenceNumber": state.minimum_sequence_number,
            "logOffset": state.log_offset,
            "clients": [
                {"clientId": c.client_id, "referenceSequenceNumber": c.ref_seq,
                 "clientSequenceNumber": c.client_seq,
                 "canEvict": c.can_evict}
                for c in state.clients.values()],
        }

    # -- live rebalance hooks (server/sharding.py handoff wrapper) ---------
    def export_doc(self, doc_id: str) -> Optional[dict]:
        """Serialize one document's live sequencing state for an epoch
        handoff (the same dump format checkpoints use). None when the
        document is not owned here — the idempotence a replayed handoff
        marker relies on."""
        state = self.docs.get(doc_id)
        if state is None:
            return None
        return self._dump(state)

    def drop_doc(self, doc_id: str, epoch: int = 0) -> None:
        """Release a handed-off document: forget the live state and
        TOMBSTONE its checkpoint row (handedOff=epoch) so a crash-restart
        of this partition does not re-adopt a document that now lives
        elsewhere. Called only after the adopt record is durably on the
        target partition."""
        self.docs.pop(doc_id, None)
        self._evicting.pop(doc_id, None)
        if self.checkpoints is not None:
            self.checkpoints.upsert(
                lambda d, _id=doc_id: d.get("documentId") == _id,
                {"documentId": doc_id, "handedOff": int(epoch)})

    def adopt_doc(self, doc_id: str, dump: dict) -> bool:
        """Install a handed-off document's state. The dump's logOffset
        indexes the SOURCE partition's log, so the replay guard resets
        (fresh_log semantics) — nothing on this partition predates the
        adoption. Idempotent: a duplicate adopt record (replayed marker
        on the source) is ignored once the document is owned."""
        if doc_id in self.docs:
            return False
        state = self.load_state(dump)
        state.log_offset = -1
        self.docs[doc_id] = state
        if self.checkpoints is not None:
            # Persist the adopted state NOW, not at the next flush
            # cadence: the source's row is already a tombstone, and
            # between adopt and the next checkpoint every cross-
            # partition reader (sequence_number introspection, node
            # takeover) would otherwise see no live row at all.
            self.checkpoints.upsert(
                lambda d, _id=doc_id: d.get("documentId") == _id,
                {"documentId": doc_id, "state": self._dump(state)})
        return True

    @staticmethod
    def load_state(dump: dict) -> DocumentDeliState:
        state = DocumentDeliState(dump["sequenceNumber"],
                                  dump["minimumSequenceNumber"],
                                  dump["logOffset"])
        for c in dump.get("clients", []):
            state.clients[c["clientId"]] = ClientSeqState(
                c["clientId"], c["referenceSequenceNumber"],
                c["clientSequenceNumber"], c.get("canEvict", True))
        return state

    # -- ticketing (reference ticket(), deli/lambda.ts:224) ----------------
    def _ticket(self, doc_id: str, state: DocumentDeliState,
                client_id: Optional[str], msg: DocumentMessage) -> None:
        mtype = msg.type
        if mtype == MessageType.CLIENT_JOIN:
            detail = _join_detail(msg)
            joining = detail.get("clientId", client_id)
            # canEvict=True for ordinary clients (reference upsertClient);
            # nonEvictable in the join detail opts service identities out
            # (legitimately silent for long stretches).
            inner = detail.get("detail") if isinstance(detail, dict) \
                else None
            can_evict = not (isinstance(inner, dict)
                             and inner.get("nonEvictable"))
            state.clients[joining] = ClientSeqState(
                joining, ref_seq=state.sequence_number, client_seq=0,
                can_evict=can_evict)
            self._sequence(doc_id, state, None, msg)
            return
        if mtype == MessageType.CLIENT_LEAVE:
            detail = _join_detail(msg)
            leaving = detail if isinstance(detail, str) else \
                detail.get("clientId", client_id)
            self._evicting.get(doc_id, set()).discard(leaving)
            if leaving in state.clients:
                del state.clients[leaving]
                self._sequence(doc_id, state, None, msg)
                if not state.clients:
                    noclient = DocumentMessage(
                        client_sequence_number=0,
                        reference_sequence_number=state.sequence_number,
                        type=MessageType.NO_CLIENT)
                    self._sequence(doc_id, state, None, noclient)
            return
        if client_id is None:
            # Server-generated control/system message.
            self._sequence(doc_id, state, None, msg)
            return
        entry = state.clients.get(client_id)
        if entry is None:
            self.nack(doc_id, client_id, Nack(
                msg, state.sequence_number,
                NackContent(NACK_BAD_REF_SEQ, "client not joined")))
            return
        if msg.client_sequence_number <= entry.client_seq:
            return  # duplicate (idempotent replay) — deli drops silently
        if msg.reference_sequence_number < state.minimum_sequence_number:
            self.nack(doc_id, client_id, Nack(
                msg, state.sequence_number,
                NackContent(NACK_BAD_REF_SEQ,
                            "refSeq below minimum sequence number")))
            return
        entry.client_seq = msg.client_sequence_number
        entry.ref_seq = msg.reference_sequence_number
        entry.last_update = time.time()
        self._sequence(doc_id, state, client_id, msg)

    def _evict_ghosts(self, doc_id: str, state: DocumentDeliState) -> None:
        """Synthesize leaves for writers silent past clientTimeout
        (reference deli client eviction): checked on document activity, so
        a live document cannot stay pinned behind a dead client. The leave
        goes through the raw log (replay-deterministic); without a
        producer it falls back to in-place ticketing (test harnesses)."""
        if not self.client_timeout_s:
            return
        cutoff = time.time() - self.client_timeout_s
        import json as _json
        in_flight = self._evicting.setdefault(doc_id, set())
        for client_id in [cid for cid, c in state.clients.items()
                          if c.last_update < cutoff and c.can_evict
                          and cid not in in_flight]:
            leave = DocumentMessage(
                client_sequence_number=0, reference_sequence_number=-1,
                type=MessageType.CLIENT_LEAVE,
                data=_json.dumps({"clientId": client_id,
                                  "evicted": True}))
            if self.send_system is not None:
                in_flight.add(client_id)
                # System messages enter the raw log with no client edit
                # to inherit a trace from — stamp a head-sampled root so
                # the eviction's journey joins the fleet timeline.
                tracing.stamp_message(leave, tracing.root_context())
                self.send_system(doc_id, leave)
            else:
                self._ticket(doc_id, state, None, leave)

    def _sequence(self, doc_id: str, state: DocumentDeliState,
                  client_id: Optional[str], msg: DocumentMessage) -> None:
        state.sequence_number += 1
        state.minimum_sequence_number = min(state.msn(),
                                            state.sequence_number - 1)
        sequenced = SequencedDocumentMessage.from_document_message(
            msg, client_id, state.sequence_number,
            state.minimum_sequence_number)
        # Wire-level latency trace stamp (reference deli/lambda.ts:154).
        sequenced.traces.append(ITrace.now("deli", "sequence"))
        self.emit(doc_id, sequenced)


def _join_detail(msg: DocumentMessage):
    import json
    if msg.data is not None:
        return json.loads(msg.data)
    return msg.contents or {}
