"""In-memory database collections (reference services-core ICollection /
IDatabaseManager over MongoDB).

Counterpart of fluidframework_tpu's server/database.py: the sequencer's
and scribe's checkpoints and the scriptorium's delta store live here.
Inserts are idempotent on a unique key, the way the reference relies on
duplicate-key errors being ignored on replay (scriptorium/lambda.ts:92-99).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional


class Collection:
    def __init__(self, unique_key: Optional[Callable[[dict], Any]] = None):
        self._docs: List[dict] = []
        self._unique: Dict[Any, int] = {}
        self._unique_key = unique_key
        self._lock = threading.Lock()

    def insert_one(self, doc: dict) -> bool:
        """False if a doc with the same unique key exists (idempotent
        replay)."""
        with self._lock:
            if self._unique_key is not None:
                key = self._unique_key(doc)
                if key in self._unique:
                    return False
                self._unique[key] = len(self._docs)
            self._docs.append(dict(doc))
            return True

    def insert_many(self, docs: List[dict]) -> int:
        return sum(1 for d in docs if self.insert_one(d))

    def find(self, predicate: Callable[[dict], bool]) -> List[dict]:
        with self._lock:
            return [dict(d) for d in self._docs if predicate(d)]

    def find_one(self, predicate: Callable[[dict], bool]) -> Optional[dict]:
        with self._lock:
            for d in self._docs:
                if predicate(d):
                    return dict(d)
        return None

    def upsert(self, match: Callable[[dict], bool], doc: dict) -> None:
        with self._lock:
            for i, d in enumerate(self._docs):
                if match(d):
                    self._docs[i] = dict(doc)
                    return
            self._docs.append(dict(doc))

    def __len__(self) -> int:
        with self._lock:
            return len(self._docs)


class DatabaseManager:
    """Named collections per (tenant, document) style keys."""

    def __init__(self):
        self._collections: Dict[str, Collection] = {}
        self._lock = threading.Lock()

    def collection(self, name: str,
                   unique_key: Optional[Callable[[dict], Any]] = None
                   ) -> Collection:
        with self._lock:
            if name not in self._collections:
                self._collections[name] = Collection(unique_key)
            return self._collections[name]
