"""Production resilience wrappers: retry/backoff, throttle honoring,
single-flight fetch dedup, snapshot prefetch.

Capability parity with the reference odsp-driver's network hardening
(packages/drivers/odsp-driver: retryAndConvertToNetworkError, throttling
(429 retryAfter) handling, prefetchSnapshot, concurrent fetch dedup) —
decorating any `IDocumentServiceFactory`, usually stacked OUTSIDE the
caching driver:

    factory = RetryingDocumentServiceFactory(
        CachingDocumentServiceFactory(inner, cache), policy)

A port of fluidframework_tpu's loader/drivers/resilience.py (host only).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional

from ...core.retry import (NonRetryableError, RetryPolicy,  # noqa: F401
                           SingleFlight, ThrottlingError)
from ...telemetry.counters import record_swallow
from .base import (IDocumentDeltaStorageService, IDocumentService,
                   IDocumentServiceFactory, IDocumentStorageService)

# ThrottlingError / NonRetryableError / RetryPolicy / SingleFlight live
# in core.retry (the server's broker client reuses them and server may
# not import loader); re-exported here unchanged — this module remains
# their canonical driver-facing import path.


class RetryingStorageService(IDocumentStorageService):
    def __init__(self, inner: IDocumentStorageService, policy: RetryPolicy,
                 flight: SingleFlight, key: str):
        self.inner = inner
        self.policy = policy
        self.flight = flight
        self.key = key

    def get_summary(self, version: Optional[str] = None):
        flight_key = f"{self.key}:summary:{version}"
        return self.flight.do(flight_key, lambda: self.policy.run(
            lambda: self.inner.get_summary(version)))

    def upload_summary(self, summary, parent=None, initial: bool = False):
        # Uploads are NOT single-flighted (each is a distinct mutation).
        return self.policy.run(lambda: self.inner.upload_summary(
            summary, parent=parent, initial=initial))

    def get_versions(self, count: int = 1) -> List[str]:
        return self.policy.run(lambda: self.inner.get_versions(count))


class RetryingDeltaStorage(IDocumentDeltaStorageService):
    def __init__(self, inner: IDocumentDeltaStorageService,
                 policy: RetryPolicy):
        self.inner = inner
        self.policy = policy

    def get(self, from_seq: int, to_seq: Optional[int] = None):
        return self.policy.run(lambda: self.inner.get(from_seq, to_seq))


class RetryingDocumentService(IDocumentService):
    def __init__(self, inner: IDocumentService, policy: RetryPolicy,
                 flight: SingleFlight, key: str):
        self.inner = inner
        self.policy = policy
        self.flight = flight
        self.key = key

    def connect_to_storage(self):
        return RetryingStorageService(self.inner.connect_to_storage(),
                                      self.policy, self.flight, self.key)

    def connect_to_delta_storage(self):
        return RetryingDeltaStorage(self.inner.connect_to_delta_storage(),
                                    self.policy)

    def connect_to_delta_stream(self, client_details: Optional[dict] = None):
        # Connection attempts retry too (reference reconnect backoff).
        return self.policy.run(
            lambda: self.inner.connect_to_delta_stream(client_details))


class RetryingDocumentServiceFactory(IDocumentServiceFactory):
    def __init__(self, inner: IDocumentServiceFactory,
                 policy: Optional[RetryPolicy] = None):
        self.inner = inner
        self.policy = policy or RetryPolicy()
        self.flight = SingleFlight()

    def create_document_service(self, document_id: str) -> IDocumentService:
        return RetryingDocumentService(
            self.inner.create_document_service(document_id), self.policy,
            self.flight, document_id)

    def prefetch_snapshot(self, document_id: str) -> bool:
        """Warm the (stacked) cache before a load (reference
        prefetchSnapshot): fetch the head summary through the full wrapper
        stack; returns False when the fetch permanently failed."""
        try:
            service = self.create_document_service(document_id)
            service.connect_to_storage().get_summary()
            return True
        except Exception:  # noqa: BLE001 — prefetch is best-effort
            record_swallow("driver.prefetch_snapshot")
            return False
