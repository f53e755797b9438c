"""Telemetry logger hierarchy + performance-event spans.

Capability parity with reference packages/utils/telemetry-utils/src/
{logger.ts:238-356, debugLogger.ts:18, mockLogger.ts:14}: every layer takes
an ITelemetryLogger; ChildLogger namespaces + merges static properties;
MultiSinkLogger fans events to several sinks; PerformanceEvent wraps an
operation in start/end/cancel events with duration; MockLogger records
events for test assertions (see telemetry/mock.py).

Events are plain dicts with at least {"category", "eventName"}; errors are
folded in via tagged properties the way logger.ts prepareErrorObject does.

A port of fluidframework_tpu's telemetry/logger.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import logging
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

# Event categories (reference ITelemetryBaseEvent.category).
GENERIC = "generic"
ERROR = "error"
PERFORMANCE = "performance"


class TelemetryLogger:
    """Base logger: namespacing + property merging + error folding
    (reference TelemetryLogger, logger.ts:238)."""

    EVENT_NAME_SEPARATOR = ":"

    def __init__(self, namespace: Optional[str] = None,
                 properties: Optional[Dict[str, Any]] = None):
        self.namespace = namespace
        self.properties = dict(properties or {})

    # -- sink --------------------------------------------------------------
    def send(self, event: Dict[str, Any]) -> None:
        raise NotImplementedError

    # -- api ---------------------------------------------------------------
    def send_telemetry_event(self, event: Dict[str, Any],
                             error: Optional[BaseException] = None) -> None:
        self._send(dict(event, category=event.get("category", GENERIC)),
                   error)

    def send_error_event(self, event: Dict[str, Any],
                         error: Optional[BaseException] = None) -> None:
        self._send(dict(event, category=ERROR), error)

    def send_performance_event(self, event: Dict[str, Any],
                               error: Optional[BaseException] = None) -> None:
        self._send(dict(event, category=PERFORMANCE), error)

    def debug_assert(self, condition: bool,
                     event: Optional[Dict[str, Any]] = None) -> None:
        if not condition:
            self.send_error_event(dict(event or {},
                                       eventName="DebugAssert"))

    # -- internals ---------------------------------------------------------
    def prepare_event(self, event: Dict[str, Any]) -> Dict[str, Any]:
        """Merge static properties and apply this logger's namespace prefix
        (reference TelemetryLogger.prepareEvent); each ChildLogger in the
        chain prepares again, so namespaces accumulate root-ward."""
        prepared = dict(self.properties)
        prepared.update(event)
        if self.namespace:
            prepared["eventName"] = (self.namespace
                                     + self.EVENT_NAME_SEPARATOR
                                     + prepared.get("eventName", ""))
        return prepared

    def _send(self, event: Dict[str, Any],
              error: Optional[BaseException]) -> None:
        if error is not None:
            event = dict(event)
            event.setdefault("error", str(error))
            event.setdefault("errorType", type(error).__name__)
            tb = getattr(error, "__traceback__", None)
            if tb is not None:
                event.setdefault(
                    "stack", "".join(traceback.format_tb(tb))[-2000:])
        self.send(event)


class DebugLogger(TelemetryLogger):
    """Routes events to the stdlib ``logging`` tree (the reference routes to
    the npm `debug` package; logging is the Python moral equivalent).
    Error-category events escalate to logging.ERROR."""

    def __init__(self, namespace: str = "fluid",
                 properties: Optional[Dict[str, Any]] = None):
        super().__init__(None, properties)
        self._log = logging.getLogger(namespace)

    @staticmethod
    def create(namespace: str = "fluid",
               properties: Optional[Dict[str, Any]] = None,
               ) -> "DebugLogger":
        return DebugLogger(namespace, properties)

    def send(self, event: Dict[str, Any]) -> None:
        event = self.prepare_event(event)
        level = (logging.ERROR if event.get("category") == ERROR
                 else logging.DEBUG)
        payload = {k: v for k, v in event.items() if k != "eventName"}
        self._log.log(level, "%s %s", event.get("eventName", ""), payload)


class ChildLogger(TelemetryLogger):
    """Namespaced child over a parent logger (logger.ts ChildLogger.create):
    events flow to the root sink with namespaces joined by ':'."""

    def __init__(self, base: TelemetryLogger, namespace: Optional[str],
                 properties: Optional[Dict[str, Any]] = None):
        super().__init__(namespace, properties)
        self.base = base

    @staticmethod
    def create(base: Optional[TelemetryLogger],
               namespace: Optional[str] = None,
               properties: Optional[Dict[str, Any]] = None) -> "ChildLogger":
        return ChildLogger(base or DebugLogger(), namespace, properties)

    def send(self, event: Dict[str, Any]) -> None:
        self.base.send(self.prepare_event(event))


class MultiSinkLogger(TelemetryLogger):
    """Fans each event out to every registered sink (logger.ts:318)."""

    def __init__(self, namespace: Optional[str] = None):
        super().__init__(namespace)
        self.loggers: List[TelemetryLogger] = []

    def add_logger(self, logger: Optional[TelemetryLogger]) -> None:
        if logger is not None:
            self.loggers.append(logger)

    def send(self, event: Dict[str, Any]) -> None:
        event = self.prepare_event(event)
        for logger in self.loggers:
            logger.send(event)


class PerformanceEvent:
    """Start/end/cancel span with duration, mirroring logger.ts:356.

    Usage::

        with PerformanceEvent.timed_event(logger, {"eventName": "Load"}) as e:
            ...; e.report_progress({"phase": "snapshot"})
    """

    def __init__(self, logger: TelemetryLogger, event: Dict[str, Any],
                 emit_start: bool = True):
        self.logger = logger
        self.event = dict(event)
        self.start_time = time.perf_counter()
        self._reported = False
        if emit_start:
            self._report("start")

    @staticmethod
    def start(logger: TelemetryLogger, event: Dict[str, Any]
              ) -> "PerformanceEvent":
        return PerformanceEvent(logger, event)

    @staticmethod
    def timed_event(logger: TelemetryLogger, event: Dict[str, Any]
                    ) -> "PerformanceEvent":
        return PerformanceEvent(logger, event, emit_start=False)

    @property
    def duration_ms(self) -> float:
        return (time.perf_counter() - self.start_time) * 1000.0

    def report_progress(self, props: Optional[Dict[str, Any]] = None,
                        event_name_suffix: str = "update") -> None:
        self._report(event_name_suffix, props)

    def end(self, props: Optional[Dict[str, Any]] = None) -> None:
        if not self._reported:
            self._reported = True
            self._report("end", props)

    def cancel(self, props: Optional[Dict[str, Any]] = None,
               error: Optional[BaseException] = None) -> None:
        if not self._reported:
            self._reported = True
            self._report("cancel", props, error)

    def __enter__(self) -> "PerformanceEvent":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.cancel(error=exc)
        else:
            self.end()

    def _report(self, suffix: str,
                props: Optional[Dict[str, Any]] = None,
                error: Optional[BaseException] = None) -> None:
        event = dict(self.event)
        if props:
            event.update(props)
        event["eventName"] = f"{event.get('eventName', '')}_{suffix}"
        if suffix != "start":
            event["duration"] = self.duration_ms
        self.logger.send_performance_event(event, error)


class OpRoundTripTelemetry:
    """Measures local-op submit -> ack round trips + sequence-number lag
    (reference container-runtime/src/connectionTelemetry.ts). Sampled: one
    in-flight op is tracked at a time; the next sample starts after ack."""

    SAMPLE_EVERY = 100

    def __init__(self, client_id_fn, logger: TelemetryLogger):
        self._client_id_fn = client_id_fn
        self.logger = logger
        self._tracked_seq: Optional[int] = None  # client sequence number
        self._tracked_start = 0.0
        self._since_sample = 0

    def on_submit(self, client_seq: int) -> None:
        self._since_sample += 1
        if (self._tracked_seq is None
                and self._since_sample >= self.SAMPLE_EVERY):
            self._tracked_seq = client_seq
            self._tracked_start = time.perf_counter()
            self._since_sample = 0

    def on_sequenced(self, msg) -> None:
        if (self._tracked_seq is not None
                and msg.client_id == self._client_id_fn()
                and msg.client_sequence_number == self._tracked_seq):
            self.logger.send_performance_event({
                "eventName": "OpRoundtripTime",
                "sequenceNumber": msg.sequence_number,
                "clientSequenceNumber": msg.client_sequence_number,
                "duration": (time.perf_counter()
                             - self._tracked_start) * 1000.0,
            })
            self._tracked_seq = None
