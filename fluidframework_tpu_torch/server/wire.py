"""JSON wire codecs for protocol messages (a copy of fluidframework_tpu's
server/wire.py).

The in-process stack passes dataclass objects by reference; the network
stack (alfred websocket + REST, reference `services-client` serialization)
needs a stable JSON encoding. Field names mirror the dataclasses
(snake_case) so a row from scriptorium's delta collection and a wire
message decode identically (`loader/drivers/local.py:_row_to_message`).
"""

from __future__ import annotations

from dataclasses import asdict
from typing import List, Optional

from ..protocol.messages import (
    Boxcar,
    DocumentMessage,
    ITrace,
    Nack,
    NackContent,
    SequencedDocumentMessage,
)


def document_message_to_dict(msg: DocumentMessage) -> dict:
    return asdict(msg)


def document_message_from_dict(d: dict) -> DocumentMessage:
    return DocumentMessage(
        client_sequence_number=d["client_sequence_number"],
        reference_sequence_number=d["reference_sequence_number"],
        type=d["type"],
        contents=d.get("contents"),
        metadata=d.get("metadata"),
        server_metadata=d.get("server_metadata"),
        traces=[ITrace(**t) for t in d.get("traces", [])],
        data=d.get("data"),
    )


def sequenced_message_to_dict(msg: SequencedDocumentMessage) -> dict:
    return asdict(msg)


def sequenced_message_from_dict(d: dict) -> SequencedDocumentMessage:
    return SequencedDocumentMessage(
        client_id=d.get("client_id"),
        sequence_number=d["sequence_number"],
        minimum_sequence_number=d["minimum_sequence_number"],
        client_sequence_number=d["client_sequence_number"],
        reference_sequence_number=d["reference_sequence_number"],
        type=d["type"],
        contents=d.get("contents"),
        metadata=d.get("metadata"),
        server_metadata=d.get("server_metadata"),
        timestamp=d.get("timestamp", 0.0),
        term=d.get("term", 1),
        traces=[ITrace(**t) for t in d.get("traces", [])],
        data=d.get("data"),
        additional_content=d.get("additional_content"),
    )


def nack_to_dict(nack: Nack) -> dict:
    return {
        "operation": document_message_to_dict(nack.operation)
        if nack.operation is not None else None,
        "sequence_number": nack.sequence_number,
        "content": asdict(nack.content),
    }


def nack_from_dict(d: dict) -> Nack:
    op = d.get("operation")
    return Nack(
        operation=document_message_from_dict(op) if op else None,
        sequence_number=d["sequence_number"],
        content=NackContent(**d["content"]),
    )


def delta_rows_to_messages(rows: List[dict]) -> List[SequencedDocumentMessage]:
    return [sequenced_message_from_dict(r) for r in rows]


def boxcar_to_wire(boxcar: "Boxcar") -> bytes:
    """Canonical raw-log encoding of a boxcar (the shape a production
    Kafka topic carries; reference IBoxcarMessage JSON). Key order is part
    of the contract: the native pump (native/src/wirepump.cpp) requires
    documentId/clientId before contents, which json.dumps preserves."""
    import json as _json
    return _json.dumps({
        "tenantId": boxcar.tenant_id,
        "documentId": boxcar.document_id,
        "clientId": boxcar.client_id,
        "contents": [asdict(m) for m in boxcar.contents],
    }).encode("utf-8")


def boxcar_from_wire(raw: bytes) -> "Boxcar":
    import json as _json
    d = _json.loads(raw)
    return Boxcar(
        tenant_id=d.get("tenantId", ""),
        document_id=d.get("documentId", ""),
        client_id=d.get("clientId"),
        contents=[document_message_from_dict(m)
                  for m in d.get("contents", [])],
    )
