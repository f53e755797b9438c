"""Content-addressed summary storage + caching proxy.

A copy of fluidframework_tpu's server/storage.py, host code that the port
keeps as its own.

Capability parity with reference server/gitrest (git-style trees/blobs/
commits/refs over REST, README:1-9) and server/historian (Redis-backed
caching proxy in front of it). The git object model is kept — blobs are
content-addressed by sha, trees reference child shas, commits chain — so
incremental summaries (SummaryHandle pointing into the previous summary)
dedupe structurally, exactly like the reference's summary write path
(scribe -> historian -> gitrest).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..protocol.summary import (
    SummaryBlob,
    SummaryHandle,
    SummaryObject,
    SummaryTree,
    blob_sha,
)


@dataclass
class GitBlob:
    sha: str
    content: bytes


@dataclass
class GitTree:
    sha: str
    entries: Dict[str, Tuple[str, str]]  # name -> (kind: blob|tree, sha)


@dataclass
class GitCommit:
    sha: str
    tree_sha: str
    parents: List[str]
    message: str
    timestamp: float


class GitStore:
    """One tenant/document scope's object store (gitrest equivalent)."""

    def __init__(self):
        self._objects: Dict[str, object] = {}
        self._refs: Dict[str, str] = {}  # ref name -> commit sha
        self._lock = threading.Lock()

    # -- objects -----------------------------------------------------------
    def put_blob(self, content: bytes) -> str:
        sha = blob_sha(content)
        with self._lock:
            self._objects.setdefault(sha, GitBlob(sha, content))
        return sha

    def put_tree(self, entries: Dict[str, Tuple[str, str]]) -> str:
        canonical = json.dumps(sorted(entries.items())).encode()
        sha = blob_sha(b"tree\x00" + canonical)
        with self._lock:
            self._objects.setdefault(sha, GitTree(sha, dict(entries)))
        return sha

    def put_commit(self, tree_sha: str, parents: List[str],
                   message: str) -> str:
        ts = time.time()
        sha = blob_sha(
            f"commit\x00{tree_sha}\x00{parents}\x00{message}\x00{ts}".encode())
        with self._lock:
            self._objects[sha] = GitCommit(sha, tree_sha, list(parents),
                                           message, ts)
        return sha

    def get(self, sha: str):
        return self._objects.get(sha)

    # -- refs --------------------------------------------------------------
    def set_ref(self, name: str, commit_sha: str) -> None:
        with self._lock:
            self._refs[name] = commit_sha

    def get_ref(self, name: str) -> Optional[str]:
        return self._refs.get(name)

    # -- summary upload/download ------------------------------------------
    def write_summary(self, tree: SummaryTree, ref: str = "main",
                      message: str = "summary",
                      base_commit: Optional[str] = None,
                      advance_ref: bool = False) -> str:
        """Upload a summary tree (resolving handles against the ref's
        current commit). Returns the new commit sha.

        The ref only advances when advance_ref=True (the initial attach
        summary, or scribe acking a client summary): a client upload is a
        *proposal* — it must not become the load target until the sequenced
        summarize op is validated and acked (reference: scribe writes the
        ref, clients only upload; scribe/lambda.ts:162-192)."""
        parent = base_commit if base_commit is not None else self.get_ref(ref)
        base_tree = None
        if parent:
            commit = self.get(parent)
            base_tree = commit.tree_sha if commit else None
        tree_sha = self._write_tree(tree, base_tree)
        commit_sha = self.put_commit(tree_sha, [parent] if parent else [],
                                     message)
        if advance_ref:
            self.set_ref(ref, commit_sha)
        return commit_sha

    def _write_tree(self, node: SummaryObject, base_tree: Optional[str]) -> str:
        if isinstance(node, SummaryBlob):
            content = node.content
            if isinstance(content, str):
                content = content.encode()
            return self.put_blob(content)
        if isinstance(node, SummaryHandle):
            sha = self._resolve_handle(node.handle, base_tree)
            if sha is None:
                raise KeyError(f"unresolvable summary handle {node.handle!r}")
            return sha
        if isinstance(node, SummaryTree):
            entries: Dict[str, Tuple[str, str]] = {}
            for name, child in node.entries.items():
                # Incremental: a handle child resolves against the same-name
                # path of the base tree.
                sha = self._write_tree(child, self._child_sha(base_tree, name))
                kind = "blob" if isinstance(child, SummaryBlob) else "tree"
                if isinstance(child, SummaryHandle):
                    kind = "blob" if child.handle_type == "blob" else "tree"
                entries[name] = (kind, sha)
            return self.put_tree(entries)
        raise TypeError(f"cannot store {type(node)!r}")

    def _child_sha(self, tree_sha: Optional[str], name: str) -> Optional[str]:
        if tree_sha is None:
            return None
        tree = self.get(tree_sha)
        if not isinstance(tree, GitTree) or name not in tree.entries:
            return None
        return tree.entries[name][1]

    def _resolve_handle(self, path: str, base_tree: Optional[str]
                        ) -> Optional[str]:
        sha = base_tree
        for part in path.strip("/").split("/"):
            if not part or sha is None:
                break
            sha = self._child_sha(sha, part)
        return sha

    def read_summary(self, commit_sha: Optional[str] = None,
                     ref: str = "main",
                     lazy: bool = False) -> Optional[SummaryTree]:
        """lazy=True: blob entries resolve their content on first access
        (LazySummaryBlob) and `self.blob_fetches` counts resolutions —
        the loader's header-first / body-on-demand snapshot load."""
        sha = commit_sha or self.get_ref(ref)
        if sha is None:
            return None
        commit = self.get(sha)
        if not isinstance(commit, GitCommit):
            return None  # unknown/garbage version
        return self._read_tree(commit.tree_sha, lazy)

    blob_fetches = 0  # lazy-blob resolutions (per-store instance counter)

    def _fetch_blob(self, sha: str):
        self.blob_fetches += 1
        blob = self.get(sha)
        try:
            return blob.content.decode()
        except UnicodeDecodeError:
            return blob.content

    def _read_tree(self, tree_sha: str, lazy: bool = False) -> SummaryTree:
        from ..protocol.summary import LazySummaryBlob
        tree = self.get(tree_sha)
        out = SummaryTree()
        for name, (kind, sha) in tree.entries.items():
            if kind == "blob":
                if lazy:
                    out.entries[name] = LazySummaryBlob(
                        lambda s=sha: self._fetch_blob(s))
                else:
                    blob = self.get(sha)
                    try:
                        out.entries[name] = SummaryBlob(
                            blob.content.decode())
                    except UnicodeDecodeError:
                        out.entries[name] = SummaryBlob(blob.content)
            else:
                out.entries[name] = self._read_tree(sha, lazy)
        return out

    def list_commits(self, ref: str = "main", limit: int = 50) -> List[GitCommit]:
        out = []
        sha = self.get_ref(ref)
        while sha and len(out) < limit:
            commit = self.get(sha)
            if commit is None:
                break
            out.append(commit)
            sha = commit.parents[0] if commit.parents else None
        return out


class Historian:
    """Caching proxy over per-document GitStores (reference historian:
    the storage endpoint drivers actually talk to)."""

    def __init__(self):
        self._stores: Dict[Tuple[str, str], GitStore] = {}
        self._cache: Dict[str, object] = {}
        self._lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0

    def store(self, tenant_id: str, document_id: str) -> GitStore:
        key = (tenant_id, document_id)
        with self._lock:
            if key not in self._stores:
                self._stores[key] = GitStore()
            return self._stores[key]

    def get_cached(self, sha: str, tenant_id: str, document_id: str):
        """Object lookup through the cache. Safe to share across documents:
        objects are content-addressed, so a sha uniquely names its bytes;
        only refs (mutable) must never be cached."""
        if sha in self._cache:
            self.cache_hits += 1
            return self._cache[sha]
        self.cache_misses += 1
        obj = self.store(tenant_id, document_id).get(sha)
        if obj is not None:
            with self._lock:
                self._cache[sha] = obj
        return obj

    blob_fetches = 0  # lazy-blob resolutions through this historian

    def read_summary(self, tenant_id: str, document_id: str,
                     commit_sha: Optional[str] = None,
                     ref: str = "main",
                     lazy: bool = False) -> Optional[SummaryTree]:
        """The drivers' summary download path: identical semantics to
        GitStore.read_summary but every object fetch rides the cache, so a
        summary shared by N loading clients hits storage once. lazy=True
        defers blob content to first access (LazySummaryBlob)."""
        store = self.store(tenant_id, document_id)
        sha = commit_sha or store.get_ref(ref)
        if sha is None:
            return None
        commit = self.get_cached(sha, tenant_id, document_id)
        if not isinstance(commit, GitCommit):
            return None
        return self._read_tree_cached(commit.tree_sha, tenant_id,
                                      document_id, lazy)

    def _fetch_blob_cached(self, sha: str, tenant_id: str,
                           document_id: str):
        self.blob_fetches += 1
        blob = self.get_cached(sha, tenant_id, document_id)
        try:
            return blob.content.decode()
        except UnicodeDecodeError:
            return blob.content

    def _read_tree_cached(self, tree_sha: str, tenant_id: str,
                          document_id: str,
                          lazy: bool = False) -> SummaryTree:
        from ..protocol.summary import LazySummaryBlob
        tree = self.get_cached(tree_sha, tenant_id, document_id)
        out = SummaryTree()
        for name, (kind, sha) in tree.entries.items():
            if kind == "blob":
                if lazy:
                    out.entries[name] = LazySummaryBlob(
                        lambda s=sha: self._fetch_blob_cached(
                            s, tenant_id, document_id))
                else:
                    blob = self.get_cached(sha, tenant_id, document_id)
                    try:
                        out.entries[name] = SummaryBlob(
                            blob.content.decode())
                    except UnicodeDecodeError:
                        out.entries[name] = SummaryBlob(blob.content)
            else:
                out.entries[name] = self._read_tree_cached(
                    sha, tenant_id, document_id, lazy)
        return out
