"""Protocol op handler: the system-op state machine shared by client and server.

A copy of fluidframework_tpu's protocol/protocol_handler.py, host code
that the port keeps as its own.

Capability parity with reference
`server/routerlicious/packages/protocol-base/src/protocol.ts:50`:
tracks (minimumSequenceNumber, sequenceNumber), routes join/leave/propose/
reject system ops into the Quorum, and exposes snapshot/load of protocol
state (attributes + quorum) for summaries. The client Container and the
server Scribe lambda both run one of these over the sequenced op stream.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from .messages import MessageType, SequencedDocumentMessage
from .quorum import Quorum


class ProtocolError(Exception):
    """Sequenced-stream invariant violation (gap, bad msn) — fatal for the
    replica; the delta manager must refetch rather than continue."""


@dataclass
class ProtocolState:
    sequence_number: int
    minimum_sequence_number: int
    quorum_snapshot: dict


class ProtocolOpHandler:
    def __init__(
        self,
        minimum_sequence_number: int = 0,
        sequence_number: int = 0,
        quorum: Optional[Quorum] = None,
    ):
        self.minimum_sequence_number = minimum_sequence_number
        self.sequence_number = sequence_number
        self.quorum = quorum if quorum is not None else Quorum()

    def process_message(self, message: SequencedDocumentMessage) -> None:
        if message.sequence_number <= self.sequence_number:
            return  # duplicate / already-processed (idempotent replay)
        if message.sequence_number != self.sequence_number + 1:
            raise ProtocolError(
                f"protocol gap: have {self.sequence_number}, "
                f"got {message.sequence_number}")
        if message.minimum_sequence_number >= message.sequence_number:
            raise ProtocolError(
                f"invalid msn {message.minimum_sequence_number} >= "
                f"seq {message.sequence_number}")
        self.sequence_number = message.sequence_number

        mtype = message.type
        if mtype == MessageType.CLIENT_JOIN:
            detail = _system_data(message)
            client_id = detail.get("clientId")
            self.quorum.add_member(
                client_id, message.sequence_number, detail.get("detail"))
        elif mtype == MessageType.CLIENT_LEAVE:
            detail = _system_data(message)
            client_id = detail if isinstance(detail, str) else detail.get("clientId")
            self.quorum.remove_member(client_id)
        elif mtype == MessageType.PROPOSE:
            contents = message.contents
            if isinstance(contents, str):
                contents = json.loads(contents)
            self.quorum.add_proposal(
                contents["key"], contents["value"], message.sequence_number)
        elif mtype == MessageType.REJECT:
            self.quorum.reject_proposal(message.client_id, int(message.contents))

        # MSN advance (msn < seq is validated above, so a proposal in this
        # very message can never self-approve).
        if message.minimum_sequence_number > self.minimum_sequence_number:
            self.minimum_sequence_number = message.minimum_sequence_number
            self.quorum.update_minimum_sequence_number(
                message.minimum_sequence_number)

    # -- snapshot/load -----------------------------------------------------
    def snapshot(self) -> ProtocolState:
        return ProtocolState(
            sequence_number=self.sequence_number,
            minimum_sequence_number=self.minimum_sequence_number,
            quorum_snapshot=self.quorum.snapshot(),
        )

    @staticmethod
    def load(state: ProtocolState) -> "ProtocolOpHandler":
        return ProtocolOpHandler(
            minimum_sequence_number=state.minimum_sequence_number,
            sequence_number=state.sequence_number,
            quorum=Quorum.load(state.quorum_snapshot),
        )


def _system_data(message: SequencedDocumentMessage):
    """Join/leave details ride the system `data` field as JSON (reference
    IDocumentSystemMessage.data); fall back to contents for in-process use."""
    if message.data is not None:
        return json.loads(message.data)
    return message.contents
