"""Replay driver: a recorded op stream as a read-only live document.

Capability parity with reference packages/drivers/replay-driver
(replayController.ts, replayDocumentService.ts): wraps a snapshot + op list
(from any source — a live service's delta storage, a file-driver capture);
the "connection" delivers the recorded ops up to a controllable watermark
and rejects submission. Used for debugging and snapshot-regression replay
(replay-tool).

A port of fluidframework_tpu's loader/drivers/replay.py (host only): a
container loaded over it takes its op tail through Container._process_bulk,
so a tail of 64 ops or more on a sequence reaches the scan-apply kernel on
the container's device."""

from __future__ import annotations

from typing import List, Optional

from ...core.events import TypedEventEmitter
from ...protocol.messages import SequencedDocumentMessage
from ...protocol.summary import SummaryTree
from .base import (
    IDocumentDeltaConnection,
    IDocumentDeltaStorageService,
    IDocumentService,
    IDocumentServiceFactory,
    IDocumentStorageService,
)


class ReplayController:
    """Chooses how far to replay (reference ReplayController). The service
    starts at `start_seq` and delivers through `replay_to` (advance with
    forward())."""

    def __init__(self, replay_to: Optional[int] = None):
        self.replay_to = replay_to  # None = everything
        self._connections: List["ReplayDeltaConnection"] = []

    def forward(self, to_seq: Optional[int] = None) -> None:
        """Advance the watermark and push newly-visible ops."""
        self.replay_to = to_seq
        for conn in self._connections:
            conn.push()

    def visible(self, msg: SequencedDocumentMessage) -> bool:
        return self.replay_to is None or \
            msg.sequence_number <= self.replay_to


class ReplayStorageService(IDocumentStorageService):
    def __init__(self, summary: Optional[SummaryTree]):
        self.summary = summary

    def get_summary(self, version: Optional[str] = None):
        return self.summary

    def upload_summary(self, summary, parent=None, initial=False) -> str:
        raise PermissionError("replay documents are read-only")

    def get_versions(self, count: int = 1) -> List[str]:
        return []


class ReplayDeltaStorage(IDocumentDeltaStorageService):
    def __init__(self, ops: List[SequencedDocumentMessage],
                 controller: ReplayController):
        self.ops = ops
        self.controller = controller

    def get(self, from_seq: int, to_seq: Optional[int] = None
            ) -> List[SequencedDocumentMessage]:
        out = [m for m in self.ops
               if m.sequence_number > from_seq
               and (to_seq is None or m.sequence_number <= to_seq)
               and self.controller.visible(m)]
        return sorted(out, key=lambda m: m.sequence_number)


class ReplayDeltaConnection(TypedEventEmitter, IDocumentDeltaConnection):
    """Read-only: client identity never joins; submits are rejected."""

    def __init__(self, ops: List[SequencedDocumentMessage],
                 controller: ReplayController):
        TypedEventEmitter.__init__(self)
        self.client_id = "replay-readonly"
        self.ops = ops
        self.controller = controller
        self._delivered = 0
        controller._connections.append(self)

    def submit(self, messages) -> None:
        raise PermissionError("replay documents are read-only")

    def submit_signal(self, content) -> None:
        raise PermissionError("replay documents are read-only")

    def push(self) -> None:
        while self._delivered < len(self.ops):
            msg = self.ops[self._delivered]
            if not self.controller.visible(msg):
                break
            self._delivered += 1
            self.emit("op", msg)

    def close(self) -> None:
        self.emit("disconnect")


class ReplayDocumentService(IDocumentService):
    def __init__(self, summary: Optional[SummaryTree],
                 ops: List[SequencedDocumentMessage],
                 controller: Optional[ReplayController] = None):
        self.summary = summary
        self.ops = sorted(ops, key=lambda m: m.sequence_number)
        self.controller = controller or ReplayController()

    def connect_to_storage(self):
        return ReplayStorageService(self.summary)

    def connect_to_delta_storage(self):
        return ReplayDeltaStorage(self.ops, self.controller)

    def connect_to_delta_stream(self, client_details=None):
        conn = ReplayDeltaConnection(self.ops, self.controller)
        return conn


class ReplayDocumentServiceFactory(IDocumentServiceFactory):
    """Builds replay services from a capture source: any object exposing
    get_summary()/get_ops() — e.g. FileDocumentCapture or a live service's
    storage pair."""

    def __init__(self, summary, ops, controller=None):
        self.summary = summary
        self.ops = ops
        self.controller = controller

    def create_document_service(self, document_id: str) -> IDocumentService:
        return ReplayDocumentService(self.summary, self.ops,
                                     self.controller)
