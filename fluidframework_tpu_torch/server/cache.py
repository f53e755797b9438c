"""Cache policy for the historian tier: bounded LRU + TTL, O(1) per op.

A copy of fluidframework_tpu's server/cache.py, host code that the port
keeps as its own.

Capability parity with the reference historian's Redis front
(server/historian: RedisCache get/set with an expiry), restated as an
in-process policy module so the tier has no external service dependency.
The design discipline follows the serving literature (ISSUE refs): every
cache operation is constant time — an OrderedDict recency list, lazy TTL
expiry on access, and byte/entry ceilings enforced by popping from the
cold end — so the cache can never become the request path's long pole.

Two usage profiles in `server/historian.py`:
  - object cache: content-addressed (sha-keyed) immutable git objects;
    no TTL needed for correctness, bounded by bytes/entries only.
  - ref cache: mutable ref -> commit pointers; short TTL bounds staleness
    for writers that bypass the tier, explicit invalidation covers
    write-through commits.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Hashable, Optional, Tuple


class LruTtlCache:
    """Thread-safe LRU cache with optional per-entry TTL and byte budget.

    Counters (cumulative): hits, misses, evictions (capacity), expirations
    (TTL), invalidations (explicit), puts. `bytes` tracks the CURRENT
    cached payload size, `bytes_served` the cumulative hit payload.
    """

    def __init__(self, max_entries: int = 4096,
                 max_bytes: int = 64 * 1024 * 1024,
                 ttl_s: Optional[float] = None):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.ttl_s = ttl_s
        # key -> (value, nbytes, expires_at|None); OrderedDict end = hottest.
        self._entries: "OrderedDict[Hashable, Tuple[Any, int, Optional[float]]]" \
            = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
        self.invalidations = 0
        self.puts = 0
        self.bytes = 0
        self.bytes_served = 0

    def get(self, key: Hashable) -> Optional[Any]:
        """Returns the cached value or None. Expired entries drop here
        (lazy expiry keeps every op O(1) — no sweeper thread)."""
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            value, nbytes, expires_at = entry
            if expires_at is not None and now >= expires_at:
                del self._entries[key]
                self.bytes -= nbytes
                self.expirations += 1
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self.bytes_served += nbytes
            return value

    def contains(self, key: Hashable) -> bool:
        """Non-counting presence probe (no hit/miss accounting, no LRU
        touch): callers deciding whether work CAN be skipped — e.g. the
        historian's shared-subtree prefetch cutoff — must not skew the
        hit-rate stats operators alert on."""
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return False
            expires_at = entry[2]
            return expires_at is None or now < expires_at

    def put(self, key: Hashable, value: Any, nbytes: int = 0,
            ttl_s: Optional[float] = -1.0) -> None:
        """ttl_s: -1.0 (default) inherits the cache-level TTL; None pins
        the entry until evicted/invalidated; a float overrides."""
        ttl = self.ttl_s if ttl_s == -1.0 else ttl_s
        expires_at = (time.monotonic() + ttl) if ttl is not None else None
        with self._lock:
            self._put_locked(key, value, nbytes, expires_at)

    def _put_locked(self, key: Hashable, value: Any, nbytes: int,
                    expires_at: Optional[float]) -> None:
        """Entry write + ceiling enforcement; caller holds self._lock
        (shared by put and put_if_newer so the eviction policy cannot
        fork between them)."""
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes -= old[1]
        self._entries[key] = (value, nbytes, expires_at)
        self.bytes += nbytes
        self.puts += 1
        while (len(self._entries) > self.max_entries
               or (self.bytes > self.max_bytes
                   and len(self._entries) > 1)):
            _, (_, cold_bytes, _) = self._entries.popitem(last=False)
            self.bytes -= cold_bytes
            self.evictions += 1

    def put_if_newer(self, key: Hashable, value: Any, version: int,
                     nbytes: int = 0,
                     ttl_s: Optional[float] = -1.0) -> bool:
        """Conditional put keyed on a monotone per-entry version (the
        catch-up delta-blob profile, server/readpath.py): a publish that
        lost a race to a FRESHER artifact must never regress the cache,
        because a reader adopting the older blob would replay a longer
        residue tail than the one already served. The version rides the
        entry as (version, value); `get` callers receive the tuple and
        unwrap. Returns True when the entry was written."""
        ttl = self.ttl_s if ttl_s == -1.0 else ttl_s
        expires_at = (time.monotonic() + ttl) if ttl is not None else None
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                held = old[0]
                if isinstance(held, tuple) and len(held) == 2 \
                        and held[0] > version:
                    return False
            self._put_locked(key, (version, value), nbytes, expires_at)
        return True

    def peek_version(self, key: Hashable) -> Optional[int]:
        """Non-counting version probe for put_if_newer entries (no LRU
        touch, no hit/miss accounting): freshness gates — e.g. the
        catch-up refresh-on-read decision — must not skew the hit-rate
        stats operators alert on."""
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            held, _nbytes, expires_at = entry
            if expires_at is not None and now >= expires_at:
                return None
            if isinstance(held, tuple) and len(held) == 2:
                return int(held[0])
            return None

    def invalidate(self, key: Hashable) -> bool:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return False
            self.bytes -= entry[1]
            self.invalidations += 1
            return True

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self.bytes = 0
            self.invalidations += n
            return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "bytesServed": self.bytes_served,
                "hits": self.hits,
                "misses": self.misses,
                "hitRate": (self.hits / total) if total else 0.0,
                "evictions": self.evictions,
                "expirations": self.expirations,
                "invalidations": self.invalidations,
                "puts": self.puts,
            }
