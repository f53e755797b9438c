"""Caching driver: production-style snapshot cache + token refresh
wrapper over any inner driver.

Capability parity with reference packages/drivers/odsp-driver (6,713 LoC)
— the production driver's value-adds over plain REST: a **persistent
snapshot cache** (load from cached summary + fetch only the op tail;
write-through on summary upload; epoch-guarded invalidation when the
service's version moved), **token fetch with refresh-on-auth-failure**,
and **connection multiplexing** (one shared transport serving several
documents). The reference binds these to SPO specifics; here they decorate
any `IDocumentServiceFactory`.

A port of fluidframework_tpu's loader/drivers/caching.py (host only).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ...protocol.messages import SequencedDocumentMessage
from ...protocol.summary import (SummaryHandle, SummaryTree,
                                 summary_tree_from_dict,
                                 summary_tree_to_dict)
from .base import (IDocumentDeltaStorageService, IDocumentService,
                   IDocumentServiceFactory, IDocumentStorageService)
from .file import message_from_json, message_to_json


def _has_handles(node) -> bool:
    """True when an (incremental) summary tree contains SummaryHandles —
    such a tree is not self-contained and must not be cached as a load
    source."""
    if isinstance(node, SummaryHandle):
        return True
    if isinstance(node, SummaryTree):
        return any(_has_handles(child) for child in node.entries.values())
    return False


class PersistentCache:
    """Snapshot cache (reference odsp persistedCache): per document key
    stores {version, summary, ops} — the summary plus the op tail collected
    since. File-backed when a directory is given, else in-memory."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._mem: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in key)
        return os.path.join(self.directory, f"{safe}.json")

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            if self.directory:
                try:
                    with open(self._path(key)) as f:
                        entry = json.load(f)
                except FileNotFoundError:
                    entry = None
            else:
                entry = self._mem.get(key)
            if entry is None:
                self.misses += 1
            else:
                self.hits += 1
            return entry

    def put(self, key: str, entry: dict) -> None:
        with self._lock:
            if self.directory:
                with open(self._path(key), "w") as f:
                    json.dump(entry, f)
            else:
                self._mem[key] = entry

    def remove(self, key: str) -> None:
        with self._lock:
            if self.directory:
                try:
                    os.remove(self._path(key))
                except FileNotFoundError:
                    pass
            else:
                self._mem.pop(key, None)


class CachingStorageService(IDocumentStorageService):
    """Serves get_summary from cache when the service's head version still
    matches (epoch guard); write-through on upload."""

    def __init__(self, inner: IDocumentStorageService, cache: PersistentCache,
                 key: str):
        self.inner = inner
        self.cache = cache
        self.key = key

    def get_summary(self, version: Optional[str] = None):
        if version is not None:
            # Explicit historical version: bypass the cache entirely (the
            # cache only ever holds the document head).
            return self.inner.get_summary(version)
        entry = self.cache.get(self.key)
        versions = self.inner.get_versions(1)
        head = versions[0] if versions else None
        if entry is not None and entry.get("version") == head:
            return summary_tree_from_dict(entry["summary"])
        # Epoch moved (another client summarized) or cold: refresh.
        self.cache.remove(self.key)
        summary = self.inner.get_summary()
        if summary is not None:
            self.cache.put(self.key, {
                "version": head,
                "summary": summary_tree_to_dict(summary),
                "ops": []})
        return summary

    def upload_summary(self, summary: SummaryTree, parent=None,
                       initial: bool = False) -> str:
        handle = self.inner.upload_summary(summary, parent=parent,
                                           initial=initial)
        if _has_handles(summary):
            # An incremental upload is NOT a full tree (handles resolve
            # server-side at write time); caching it would serve a
            # handle-bearing tree to the next boot's load. Drop the entry
            # — get_summary refetches the resolved tree on demand.
            self.cache.remove(self.key)
        else:
            self.cache.put(self.key, {
                "version": handle,
                "summary": summary_tree_to_dict(summary),
                "ops": []})
        return handle

    def get_versions(self, count: int = 1) -> List[str]:
        return self.inner.get_versions(count)


class CachingDeltaStorage(IDocumentDeltaStorageService):
    """Appends fetched ops to the cache entry so the next boot replays the
    tail without refetching (reference odsp opsCache)."""

    def __init__(self, inner: IDocumentDeltaStorageService,
                 cache: PersistentCache, key: str):
        self.inner = inner
        self.cache = cache
        self.key = key

    def get(self, from_seq: int, to_seq: Optional[int] = None
            ) -> List[SequencedDocumentMessage]:
        entry = self.cache.get(self.key)
        # Only the CONTIGUOUS cached run starting at from_seq+1 is usable —
        # a cached tail beyond a hole (e.g. ops that arrived over the live
        # stream and were never cached) must not mask the hole.
        cached: List[SequencedDocumentMessage] = []
        if entry is not None:
            run = sorted((message_from_json(d) for d in entry.get("ops", [])
                          if d["sequenceNumber"] > from_seq
                          and (to_seq is None
                               or d["sequenceNumber"] <= to_seq)),
                         key=lambda m: m.sequence_number)
            expect = from_seq + 1
            for m in run:
                if m.sequence_number != expect:
                    break
                cached.append(m)
                expect += 1
        start = cached[-1].sequence_number if cached else from_seq
        fetched = self.inner.get(start, to_seq)
        if fetched and entry is not None:
            known = {d["sequenceNumber"] for d in entry.get("ops", [])}
            entry.setdefault("ops", []).extend(
                message_to_json(m) for m in fetched
                if m.sequence_number not in known)
            self.cache.put(self.key, entry)
        return cached + fetched


class TokenRefreshWrapper:
    """Token fetch + refresh-on-failure (reference odsp tokenFetcher):
    `token_provider(refresh: bool)` returns a token; an auth failure in the
    wrapped call triggers one forced-refresh retry."""

    def __init__(self, token_provider: Callable[[bool], str]):
        self.token_provider = token_provider
        self._token: Optional[str] = None

    def token(self, refresh: bool = False) -> str:
        if self._token is None or refresh:
            self._token = self.token_provider(refresh)
        return self._token

    def call(self, fn: Callable[[str], object]):
        try:
            return fn(self.token())
        except PermissionError:
            return fn(self.token(refresh=True))


class CachingDocumentService(IDocumentService):
    def __init__(self, inner: IDocumentService, cache: PersistentCache,
                 key: str):
        self.inner = inner
        self.cache = cache
        self.key = key

    def connect_to_storage(self):
        return CachingStorageService(self.inner.connect_to_storage(),
                                     self.cache, self.key)

    def connect_to_delta_storage(self):
        return CachingDeltaStorage(self.inner.connect_to_delta_storage(),
                                   self.cache, self.key)

    def connect_to_delta_stream(self, client_details: Optional[dict] = None):
        # The live stream always goes to the real service (multiplexing
        # happens below this layer in the shared transport).
        return self.inner.connect_to_delta_stream(client_details)


class CachingDocumentServiceFactory(IDocumentServiceFactory):
    """Decorates any factory with the persistent cache. One factory = one
    cache = one shared transport namespace, mirroring the odsp driver's
    one-socket-many-documents multiplexing shape.

    historian_url composes the client cache with the SERVER-side cache
    tier (server/historian.py): the inner factory's storage endpoint
    repoints at the tier, so even this cache's epoch-check misses (head
    moved, cold boot) serve their blobs from the historian instead of
    GitStore."""

    def __init__(self, inner: IDocumentServiceFactory,
                 cache: Optional[PersistentCache] = None,
                 historian_url: Optional[str] = None):
        self.inner = inner
        self.cache = cache or PersistentCache()
        self.historian_url = historian_url
        if historian_url is not None:
            set_endpoint = getattr(inner, "set_historian_endpoint", None)
            if set_endpoint is None:
                raise TypeError(
                    f"{type(inner).__name__} does not support a historian "
                    "endpoint (no set_historian_endpoint)")
            set_endpoint(historian_url)
        self._services: Dict[str, CachingDocumentService] = {}

    def create_document_service(self, document_id: str) -> IDocumentService:
        if document_id not in self._services:
            self._services[document_id] = CachingDocumentService(
                self.inner.create_document_service(document_id),
                self.cache, document_id)
        return self._services[document_id]
