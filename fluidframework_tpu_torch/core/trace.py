"""Hi-resolution split timer (reference common-utils/src/trace.ts:12)."""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class TraceEvent:
    total_time_elapsed_ms: float
    duration_ms: float
    tick: float


class Trace:
    @staticmethod
    def start() -> "Trace":
        return Trace()

    def __init__(self):
        self.start_tick = time.perf_counter()
        self.last_tick = self.start_tick

    def trace(self) -> TraceEvent:
        current = time.perf_counter()
        event = TraceEvent(
            total_time_elapsed_ms=(current - self.start_tick) * 1000.0,
            duration_ms=(current - self.last_tick) * 1000.0,
            tick=current,
        )
        self.last_tick = current
        return event
