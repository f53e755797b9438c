"""DeltaScheduler: time-sliced inbound op processing.

Capability parity with reference container-runtime/src/deltaScheduler.ts:25:
when a long catch-up drain is processing many sequenced ops back-to-back,
processing is interrupted every `quantum_ms` of wall time so the host
regains control (the reference pauses the inbound DeltaQueue and resumes on
a timer; here the DeltaManager releases the op lock and calls `yield_fn`,
letting application threads read DDS state between slices).

Counters (`batches`, `interruptions`, `ops_processed`) surface scheduling
behavior to telemetry, mirroring the reference's deltaScheduler telemetry
event (time-to-process over 2s gets logged there).

A port of fluidframework_tpu's loader/delta_scheduler.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class DeltaScheduler:
    DEFAULT_QUANTUM_MS = 20.0

    def __init__(self, quantum_ms: float = DEFAULT_QUANTUM_MS,
                 yield_fn: Optional[Callable[[], None]] = None):
        self.quantum_s = quantum_ms / 1000.0
        self.yield_fn = yield_fn or (lambda: time.sleep(0))
        self.batches = 0        # contiguous processing slices started
        self.interruptions = 0  # times processing yielded mid-drain
        self.ops_processed = 0
        self._slice_start: Optional[float] = None

    def op_started(self) -> None:
        if self._slice_start is None:
            self._slice_start = time.perf_counter()
            self.batches += 1

    def op_processed(self) -> None:
        self.ops_processed += 1

    def should_yield(self) -> bool:
        return (self._slice_start is not None
                and time.perf_counter() - self._slice_start > self.quantum_s)

    def on_yield(self) -> None:
        """Called by the DeltaManager with the op lock RELEASED."""
        self.interruptions += 1
        self._slice_start = None
        self.yield_fn()

    def drain_done(self) -> None:
        self._slice_start = None
