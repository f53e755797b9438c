"""Debugger driver: step through op history under manual control.

Capability parity with reference packages/drivers/debugger
(fluidDebuggerController.ts): wraps any document service; inbound sequenced
ops are held in a queue and released N at a time (or all), letting a human
(or test) inspect intermediate document states. A port of
fluidframework_tpu's loader/drivers/debug.py (host only)."""

from __future__ import annotations

from typing import List, Optional

from ...core.events import TypedEventEmitter
from .base import (
    IDocumentDeltaConnection,
    IDocumentService,
    IDocumentServiceFactory,
)


class DebugController:
    """step(n)/go() gate op delivery (reference DebuggerUI buttons)."""

    def __init__(self, paused: bool = True):
        self.paused = paused
        self._connections: List["DebugDeltaConnection"] = []

    def step(self, count: int = 1) -> int:
        released = 0
        for conn in self._connections:
            released += conn.release(count)
        return released

    def go(self) -> None:
        self.paused = False
        for conn in self._connections:
            conn.release(None)

    def pause(self) -> None:
        self.paused = True


class DebugDeltaConnection(TypedEventEmitter, IDocumentDeltaConnection):
    def __init__(self, inner: IDocumentDeltaConnection,
                 controller: DebugController):
        TypedEventEmitter.__init__(self)
        self.inner = inner
        self.client_id = inner.client_id
        self.controller = controller
        self._held: List = []
        controller._connections.append(self)
        inner.on("op", self._on_op)
        inner.on("nack", lambda n: self.emit("nack", n))
        inner.on("signal", lambda s: self.emit("signal", s))
        inner.on("disconnect", lambda: self.emit("disconnect"))

    def _on_op(self, message) -> None:
        if self.controller.paused:
            self._held.append(message)
        else:
            self.emit("op", message)

    def release(self, count: Optional[int]) -> int:
        n = len(self._held) if count is None else min(count, len(self._held))
        for _ in range(n):
            self.emit("op", self._held.pop(0))
        return n

    @property
    def held_count(self) -> int:
        return len(self._held)

    def submit(self, messages) -> None:
        self.inner.submit(messages)

    def submit_signal(self, content) -> None:
        self.inner.submit_signal(content)

    def close(self) -> None:
        self.inner.close()


class DebugDocumentService(IDocumentService):
    def __init__(self, inner: IDocumentService, controller: DebugController):
        self.inner = inner
        self.controller = controller

    def connect_to_storage(self):
        return self.inner.connect_to_storage()

    def connect_to_delta_storage(self):
        return self.inner.connect_to_delta_storage()

    def connect_to_delta_stream(self, client_details=None):
        return DebugDeltaConnection(
            self.inner.connect_to_delta_stream(client_details),
            self.controller)


class DebugDocumentServiceFactory(IDocumentServiceFactory):
    def __init__(self, inner: IDocumentServiceFactory,
                 controller: Optional[DebugController] = None):
        self.inner = inner
        self.controller = controller or DebugController()

    def create_document_service(self, document_id: str) -> IDocumentService:
        return DebugDocumentService(
            self.inner.create_document_service(document_id), self.controller)
