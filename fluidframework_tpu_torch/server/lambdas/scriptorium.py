"""Scriptorium: persists sequenced deltas (reference scriptorium/lambda.ts:
16-103 — batched Mongo insertMany, idempotent on duplicate keys, traces
stripped before persisting), and the delta store's range query (alfred's
delta REST route).

A copy of fluidframework_tpu's server/lambdas/scriptorium.py, host code
that the port keeps as its own.
"""

from __future__ import annotations

from dataclasses import asdict
from typing import List

from ...protocol.messages import SequencedDocumentMessage
from ..database import Collection
from ..log import QueuedMessage
from .base import IPartitionLambda, LambdaContext


class ScriptoriumLambda(IPartitionLambda):
    def __init__(self, context: LambdaContext, deltas: Collection):
        self.context = context
        self.deltas = deltas

    def handler(self, message: QueuedMessage) -> None:
        value = message.value
        if hasattr(value, "messages"):
            # A SequencedWindow (the device sequencer's fast path): ONE log
            # record per flush; persist every admitted message it carries —
            # the reference's insertMany batch, naturally window-sized.
            for doc_id, sequenced in value.messages():
                self._persist(doc_id, sequenced)
            self.context.checkpoint(message.offset)
            return
        doc_id, sequenced = value
        self._persist(doc_id, sequenced)
        self.context.checkpoint(message.offset)

    def _persist(self, doc_id: str,
                 sequenced: SequencedDocumentMessage) -> None:
        record = asdict(sequenced)
        record["traces"] = []  # strip latency traces before persisting
        record["documentId"] = doc_id
        # The in-memory collection makes the reference's batched async
        # insertMany a synchronous insert; duplicates (replay) are ignored.
        self.deltas.insert_one(record)


def delta_key(doc: dict):
    """The delta store's unique key: (document id, sequence number)."""
    return (doc["documentId"], doc["sequence_number"])


def query_deltas(deltas: Collection, document_id: str, from_seq: int = 0,
                 to_seq=None) -> List[dict]:
    """Rows with from_seq < seq <= to_seq, ordered by seq."""
    hi = to_seq if to_seq is not None else 2 ** 62
    out = deltas.find(
        lambda d: d["documentId"] == document_id
        and from_seq < d["sequence_number"] <= hi)
    out.sort(key=lambda d: d["sequence_number"])
    return out
