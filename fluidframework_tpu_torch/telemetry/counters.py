"""Process-wide named counters: the subset of fluidframework_tpu's
telemetry/counters.py that the port's catch-up reaches (`increment`, and
`get` to read one back). Stdlib only, so every layer can import it."""

from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()
_counters: Dict[str, float] = {}


def increment(name: str, by: float = 1.0) -> float:
    with _lock:
        _counters[name] = value = _counters.get(name, 0.0) + by
        return value


def get(name: str) -> float:
    with _lock:
        return _counters.get(name, 0.0)
