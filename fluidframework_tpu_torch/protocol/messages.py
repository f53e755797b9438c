"""Wire message types for the total-order broadcast protocol (a copy of
fluidframework_tpu's protocol/messages.py).

Capability parity with reference
`server/routerlicious/packages/protocol-definitions/src/protocol.ts:6-180`:
the unsequenced client->server `IDocumentMessage`, the server-stamped
`ISequencedDocumentMessage`, nacks, signals, and boxcar batching
(`services-core/src/lambdas.ts:75-120`).

These dataclasses are the *host-side* view. The hot path never loops over
them one by one — `server.ticket_kernel` and `mergetree.kernel` consume
packed int32 tensors built by `mergetree.oppack.pack_ops`; these objects
are the interchange / serialization form at the edges (drivers, storage,
tests).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field, asdict
from typing import Any, List, Optional


class MessageType:
    """Op types carried over the ordered log (reference protocol.ts:6-48)."""

    NO_OP = "noop"
    CLIENT_JOIN = "join"
    CLIENT_LEAVE = "leave"
    PROPOSE = "propose"
    REJECT = "reject"
    SUMMARIZE = "summarize"
    SUMMARY_ACK = "summaryAck"
    SUMMARY_NACK = "summaryNack"
    OPERATION = "op"
    CHUNKED_OP = "chunkedOp"
    SAVE = "saveOp"
    NO_CLIENT = "noClient"
    REMOTE_HELP = "remoteHelp"
    ROUND_TRIP = "tripComplete"
    CONTROL = "control"

    SYSTEM_TYPES = frozenset(
        {CLIENT_JOIN, CLIENT_LEAVE, PROPOSE, REJECT, NO_CLIENT,
         SUMMARY_ACK, SUMMARY_NACK}
    )


@dataclass
class ITrace:
    """Per-hop latency trace stamped by each service (protocol.ts:50-62)."""

    service: str
    action: str
    timestamp: float

    @staticmethod
    def now(service: str, action: str) -> "ITrace":
        return ITrace(service, action, time.time() * 1000.0)


@dataclass
class DocumentMessage:
    """A client-submitted, not-yet-sequenced op (reference IDocumentMessage)."""

    client_sequence_number: int
    reference_sequence_number: int
    type: str
    contents: Any = None
    metadata: Any = None
    server_metadata: Any = None
    traces: List[ITrace] = field(default_factory=list)
    # System messages carry an extra opaque data payload (IDocumentSystemMessage).
    data: Optional[str] = None

    def to_json(self) -> str:
        return json.dumps(asdict(self), default=str)


@dataclass
class SequencedDocumentMessage:
    """An op stamped by the sequencer (reference ISequencedDocumentMessage).

    `client_id` is None for server-generated messages (e.g. NoClient).
    """

    client_id: Optional[str]
    sequence_number: int
    minimum_sequence_number: int
    client_sequence_number: int
    reference_sequence_number: int
    type: str
    contents: Any = None
    metadata: Any = None
    server_metadata: Any = None
    timestamp: float = 0.0
    term: int = 1
    traces: List[ITrace] = field(default_factory=list)
    data: Optional[str] = None
    # Content added by the sequencer itself (ISequencedDocumentAugmentedMessage).
    additional_content: Optional[str] = None

    def to_json(self) -> str:
        return json.dumps(asdict(self), default=str)

    @staticmethod
    def from_document_message(
        msg: DocumentMessage,
        client_id: Optional[str],
        sequence_number: int,
        minimum_sequence_number: int,
        timestamp: Optional[float] = None,
    ) -> "SequencedDocumentMessage":
        return SequencedDocumentMessage(
            client_id=client_id,
            sequence_number=sequence_number,
            minimum_sequence_number=minimum_sequence_number,
            client_sequence_number=msg.client_sequence_number,
            reference_sequence_number=msg.reference_sequence_number,
            type=msg.type,
            contents=msg.contents,
            metadata=msg.metadata,
            server_metadata=msg.server_metadata,
            timestamp=time.time() * 1000.0 if timestamp is None else timestamp,
            traces=list(msg.traces),
            data=msg.data,
        )


# Nack reason codes (reference INackContent semantics: deli/lambda.ts nacks).
NACK_BAD_REF_SEQ = 400
NACK_DUPLICATE = 409
NACK_TOO_LARGE = 413
NACK_THROTTLED = 429
NACK_NOT_WRITER = 403
# Admission-control DEGRADE: the server is refusing ingest entirely
# until pressure drains (server/admission.py). Drivers honor the
# retry_after exactly like a 429 — resubmitting sooner cannot succeed.
NACK_SERVICE_UNAVAILABLE = 503


@dataclass
class NackContent:
    code: int
    message: str = ""
    retry_after_s: Optional[float] = None


@dataclass
class Nack:
    """Rejection of a submitted op (reference INack, protocol.ts:64-74)."""

    operation: Optional[DocumentMessage]
    sequence_number: int
    content: NackContent


def op_size(msg: "DocumentMessage") -> int:
    """CHEAP lower bound on one client message's payload size — the
    op-size ceiling (NACK_TOO_LARGE) screens with this at the in-process
    front door without re-serializing every op. Follows the envelope
    "contents" chain (store -> channel -> op) summing string payloads at
    each level, which covers every shape that actually gets big: text
    inserts, LWW values, chunked-op pieces, system `data`. It is a
    screen, not an exact measure — the network ingress additionally
    applies `op_size_exact` to wire-parsed messages."""
    def _bytes(s: str) -> int:
        # The wire serializer is json.dumps with ensure_ascii, so every
        # non-ASCII char costs 6+ bytes (\\uXXXX). unicode_escape is a
        # cheap LOWER bound of that (4-10 bytes/char escaped, ASCII ~1:1)
        # and far tighter than char count, keeping the front-door screen
        # close to what the websocket ingress will bill exactly.
        try:
            return len(s.encode("unicode_escape"))
        except UnicodeEncodeError:  # defensive: bill 1 byte/char
            return len(s)

    n = _bytes(msg.data) if isinstance(msg.data, str) else 0
    node = msg.contents
    depth = 0
    while isinstance(node, dict) and depth < 8:
        for key, value in node.items():
            # The followed "contents" tail is measured at ITS level (or as
            # the final string) — counting it here too would double-bill.
            if key != "contents" and isinstance(value, str):
                n += _bytes(value)
        node = node.get("contents")
        depth += 1
    if isinstance(node, str):
        n += _bytes(node)
    return n


def op_size_exact(msg: "DocumentMessage") -> int:
    """Exact serialized payload size (full dumps) — the network ingress
    measure, where one extra serialization is noise next to the socket
    I/O. Unserializable in-process payloads screen as 0 (they never
    arrive via the wire)."""
    try:
        # json.dumps default ensure_ascii escapes non-ASCII, so its char
        # count IS its byte count — and `data` is serialized inside the
        # same dumps on the wire (wire.py), so it is billed escaped too.
        n = len(json.dumps(msg.contents)) if msg.contents is not None else 0
        if msg.data is not None:
            n += len(json.dumps(msg.data)) - 2  # minus the quotes
        return n
    except (TypeError, ValueError):
        return 0


@dataclass
class SignalMessage:
    """Transient, unsequenced client-to-clients message (reference ISignalMessage)."""

    client_id: Optional[str]
    content: Any


@dataclass
class Boxcar:
    """A batch of raw client messages for one document riding one log record.

    Reference: IBoxcarMessage + extractBoxcar (services-core/src/lambdas.ts:75-120).
    Boxcarring amortizes log-append overhead; the device sequencer goes
    further and tickets whole boxcars as one tensor op
    (server/ticket_kernel.py).
    """

    tenant_id: str
    document_id: str
    client_id: Optional[str]
    contents: List[DocumentMessage] = field(default_factory=list)


def extract_boxcar(record: Any) -> Boxcar:
    """Normalize a raw log record into a Boxcar (single messages get wrapped)."""
    if isinstance(record, Boxcar):
        return record
    if isinstance(record, DocumentMessage):
        return Boxcar(tenant_id="", document_id="", client_id=None, contents=[record])
    raise TypeError(f"cannot extract boxcar from {type(record)!r}")
