"""Telemetry: counters and latency histograms, op tracing, the device
stats planes and their fold, the compile ledger, and the logger hierarchy
(perf spans, op round-trip measurement, the mock logger)."""

from .logger import (
    ERROR,
    GENERIC,
    PERFORMANCE,
    ChildLogger,
    DebugLogger,
    MultiSinkLogger,
    OpRoundTripTelemetry,
    PerformanceEvent,
    TelemetryLogger,
)
from .mock import MockLogger

__all__ = [
    "ERROR", "GENERIC", "PERFORMANCE",
    "ChildLogger", "DebugLogger", "MultiSinkLogger",
    "OpRoundTripTelemetry", "PerformanceEvent", "TelemetryLogger",
    "MockLogger",
]
