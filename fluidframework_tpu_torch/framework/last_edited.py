"""Last-edited tracker.

Capability parity with reference packages/framework/last-edited-experimental
(`lastEditedTracker.ts`, `setup.ts`): tracks who edited the container last
and when, stored in a SharedSummaryBlock (no ops of its own — the detail
rides summaries only), updated from an "op" listener on the container that
discards non-edit messages, resolving the editing user through the quorum.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..dds.summary_block import SharedSummaryBlock
from ..protocol.messages import MessageType, SequencedDocumentMessage

LAST_EDITED_KEY = "lastEditDetails"


def should_discard_message_default(message: SequencedDocumentMessage) -> bool:
    """Only real edits count (reference shouldDiscardMessageDefault: keep
    Attach + FluidDataStoreOp, discard the rest)."""
    return message.type not in (MessageType.OPERATION,
                                MessageType.CHUNKED_OP)


class LastEditedTracker:
    """Reference LastEditedTracker over a SharedSummaryBlock."""

    def __init__(self, summary_block: SharedSummaryBlock):
        self.summary_block = summary_block

    @property
    def IFluidLastEditedTracker(self) -> "LastEditedTracker":
        return self

    def get_last_edit_details(self) -> Optional[dict]:
        return self.summary_block.get(LAST_EDITED_KEY)

    def update_last_edit_details(self, details: dict) -> None:
        self.summary_block.set(LAST_EDITED_KEY, details)


def setup_last_edited_tracking(
        tracker: LastEditedTracker, container,
        should_discard: Callable[[SequencedDocumentMessage], bool]
        = should_discard_message_default) -> None:
    """Wire a container's op stream into the tracker (reference
    setupLastEditedTrackerForContainer): per kept message, resolve the
    sender in the quorum for user details and record (user, timestamp)."""

    def on_op(message: SequencedDocumentMessage, *_rest: Any) -> None:
        if should_discard(message):
            return
        member = container.protocol.quorum.get_member(message.client_id)
        if member is None:
            return
        details = member.details if isinstance(member.details, dict) else {}
        tracker.update_last_edit_details({
            "clientId": message.client_id,
            "user": details.get("user", {}),
            "timestamp": message.timestamp,
            "sequenceNumber": message.sequence_number,
        })

    container.on("op", on_op)
