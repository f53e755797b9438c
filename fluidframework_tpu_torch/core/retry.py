"""Layer-free retry primitives: bounded-backoff policy, throttle
signaling, single-flight dedup (a port of fluidframework_tpu's
core/retry.py; host only, no tensors).

`loader/drivers/resilience.py` (the odsp-driver network-hardening parity
surface) re-exports them unchanged; they live in core so that a server
module may reuse the bounded-backoff reconnect without importing the
loader, which sits above the server."""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional


class ThrottlingError(Exception):
    """Service asked the client to back off (reference 429 retryAfter)."""

    def __init__(self, retry_after_s: float, message: str = "throttled"):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class NonRetryableError(Exception):
    """Fatal service response: retrying cannot help (4xx-class)."""


class RetryPolicy:
    """Exponential backoff with full jitter, capped attempts/delay; a
    ThrottlingError's retry_after overrides the computed delay."""

    def __init__(self, max_attempts: int = 5, base_delay_s: float = 0.05,
                 max_delay_s: float = 8.0,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.sleep = sleep
        self.rng = rng or random.Random()

    def run(self, fn: Callable[[], object], on_retry=None):
        attempt = 0
        while True:
            try:
                return fn()
            except NonRetryableError:
                raise
            except ThrottlingError as err:
                attempt += 1
                if attempt >= self.max_attempts:
                    raise
                delay = min(err.retry_after_s, self.max_delay_s)
            except Exception:  # noqa: BLE001 — transient service failure
                attempt += 1
                if attempt >= self.max_attempts:
                    raise
                cap = min(self.max_delay_s,
                          self.base_delay_s * (2 ** (attempt - 1)))
                delay = self.rng.uniform(0, cap)  # full jitter
            if on_retry is not None:
                on_retry(attempt, delay)
            self.sleep(delay)


class SingleFlight:
    """Concurrent identical fetches collapse into one in-flight call
    (reference odsp snapshot fetch dedup)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: Dict[str, threading.Event] = {}
        self._results: Dict[str, object] = {}

    def do(self, key: str, fn: Callable[[], object]):
        with self._lock:
            event = self._inflight.get(key)
            if event is None:
                event = threading.Event()
                self._inflight[key] = event
                leader = True
            else:
                leader = False
        if not leader:
            event.wait()
            outcome = self._results[key]
            if isinstance(outcome, BaseException):
                raise outcome
            return outcome
        try:
            result = fn()
            outcome: object = result
        except BaseException as err:  # propagate to followers too
            outcome = err
            raise
        finally:
            with self._lock:
                self._results[key] = outcome
                del self._inflight[key]
            event.set()
        return result
