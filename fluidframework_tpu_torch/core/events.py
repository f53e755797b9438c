"""Minimal typed event emitter + Deferred (reference common-utils
TypedEventEmitter, Deferred); a copy of fluidframework_tpu's
core/events.py, stdlib only."""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional


class TypedEventEmitter:
    def __init__(self):
        self._listeners: Dict[str, List[Callable]] = {}

    def on(self, event: str, fn: Callable) -> Callable:
        self._listeners.setdefault(event, []).append(fn)
        return fn

    def once(self, event: str, fn: Callable) -> None:
        def wrapper(*args, **kwargs):
            self.off(event, wrapper)
            fn(*args, **kwargs)
        self.on(event, wrapper)

    def off(self, event: str, fn: Callable) -> None:
        listeners = self._listeners.get(event)
        if listeners and fn in listeners:
            listeners.remove(fn)

    def emit(self, event: str, *args, **kwargs) -> None:
        for fn in list(self._listeners.get(event, [])):
            fn(*args, **kwargs)

    def listener_count(self, event: str) -> int:
        return len(self._listeners.get(event, []))


class Deferred:
    """A one-shot promise usable across threads (reference common-utils
    Deferred): resolve/reject once; result() blocks until settled. Over
    in-process drivers settlement is usually synchronous, so result()
    returns immediately; over network drivers the resolver runs on the
    connection's reader thread."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    @property
    def settled(self) -> bool:
        return self._event.is_set()

    def resolve(self, value: Any = None) -> None:
        if not self._event.is_set():
            self._value = value
            self._event.set()

    def reject(self, error: BaseException) -> None:
        if not self._event.is_set():
            self._error = error
            self._event.set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("deferred not settled within timeout")
        if self._error is not None:
            raise self._error
        return self._value
