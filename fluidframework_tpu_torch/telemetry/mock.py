"""MockLogger for test assertions (reference telemetry-utils/src/
mockLogger.ts:14): records every event; match helpers assert that expected
events arrived (in order), as mockLogger.matchEvents does.

A port of fluidframework_tpu's telemetry/mock.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from .logger import TelemetryLogger


class MockLogger(TelemetryLogger):
    def __init__(self):
        super().__init__()
        self.events: List[Dict[str, Any]] = []

    def send(self, event: Dict[str, Any]) -> None:
        self.events.append(self.prepare_event(event))

    def clear(self) -> None:
        self.events = []

    def match_events(self, expected: Sequence[Dict[str, Any]]) -> bool:
        """True iff `expected` is an ordered subsequence, where each expected
        dict is a subset-match of a recorded event."""
        it = iter(self.events)
        for want in expected:
            for got in it:
                if all(got.get(k) == v for k, v in want.items()):
                    break
            else:
                return False
        return True

    def assert_match_any(self, expected: Dict[str, Any]) -> None:
        assert any(all(e.get(k) == v for k, v in expected.items())
                   for e in self.events), \
            f"no event matching {expected!r} in {self.events!r}"
