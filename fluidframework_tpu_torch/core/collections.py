"""Core collections (capability parity with reference common-utils heap,
common-utils rangeTracker, and merge-tree/src/collections.ts RedBlackTree /
IntervalTree — re-designed: we use Python's heapq and a sorted-list-backed
ordered map instead of hand-rolled red-black rotations; the *device-side*
equivalents of these structures are flat arrays in mergetree/kernel.py).
"""

from __future__ import annotations

import bisect
import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Generic, Iterator, List, Optional, Tuple, TypeVar

T = TypeVar("T")


class Heap(Generic[T]):
    """Min-heap with arbitrary key and lazy removal (reference common-utils Heap;
    used like deli's ClientSequenceNumberManager heap). Each item has at most
    one live entry; remove/update tombstone the current entry by identity so a
    re-pushed item is never confused with its stale entry."""

    def __init__(self, key: Callable[[T], Any] = lambda x: x):
        self._key = key
        self._heap: List[List[Any]] = []  # [key, tiebreak, item, live]
        self._counter = itertools.count()
        self._entries: dict = {}  # id(item) -> live entry

    def push(self, item: T) -> None:
        self.remove(item)  # keep the at-most-one-live-entry invariant
        entry = [self._key(item), next(self._counter), item, True]
        self._entries[id(item)] = entry
        heapq.heappush(self._heap, entry)

    def peek(self) -> Optional[T]:
        self._prune()
        return self._heap[0][2] if self._heap else None

    def pop(self) -> Optional[T]:
        self._prune()
        if not self._heap:
            return None
        entry = heapq.heappop(self._heap)
        self._entries.pop(id(entry[2]), None)
        return entry[2]

    def remove(self, item: T) -> None:
        entry = self._entries.pop(id(item), None)
        if entry is not None:
            entry[3] = False

    def update(self, item: T) -> None:
        """Re-key an item: tombstone its current entry, push a fresh one."""
        self.remove(item)
        self.push(item)

    def _prune(self) -> None:
        while self._heap and not self._heap[0][3]:
            heapq.heappop(self._heap)

    def __len__(self) -> int:
        return len(self._entries)


@dataclass
class RangeTracker:
    """Maps a monotonically increasing primary range onto a secondary range
    (reference common-utils rangeTracker — used to map sequence numbers to log
    offsets for checkpointing)."""

    ranges: List[Tuple[int, int]] = field(default_factory=list)  # (primary, secondary)

    def add(self, primary: int, secondary: int) -> None:
        if self.ranges and primary < self.ranges[-1][0]:
            raise ValueError("primary values must be non-decreasing")
        self.ranges.append((primary, secondary))

    def get(self, primary: int) -> int:
        """Secondary value for the closest primary <= the given one."""
        idx = bisect.bisect_right(self.ranges, (primary, float("inf"))) - 1
        if idx < 0:
            raise KeyError(primary)
        return self.ranges[idx][1]

    def update_base(self, primary: int) -> None:
        """Drop ranges below primary (checkpoint trim)."""
        idx = bisect.bisect_right(self.ranges, (primary, float("inf"))) - 1
        if idx > 0:
            self.ranges = self.ranges[idx:]


K = TypeVar("K")
V = TypeVar("V")


class RedBlackTree(Generic[K, V]):
    """Ordered map. Reference merge-tree keeps a hand-written red-black tree
    (collections.ts); a bisect-backed sorted array gives the same O(log n)
    search with simpler code and better cache behavior host-side."""

    def __init__(self):
        self._keys: List[K] = []
        self._vals: List[V] = []

    def put(self, key: K, value: V) -> None:
        i = bisect.bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            self._vals[i] = value
        else:
            self._keys.insert(i, key)
            self._vals.insert(i, value)

    def get(self, key: K) -> Optional[V]:
        i = bisect.bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            return self._vals[i]
        return None

    def remove(self, key: K) -> None:
        i = bisect.bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            del self._keys[i]
            del self._vals[i]

    def floor(self, key: K) -> Optional[Tuple[K, V]]:
        i = bisect.bisect_right(self._keys, key) - 1
        return (self._keys[i], self._vals[i]) if i >= 0 else None

    def ceil(self, key: K) -> Optional[Tuple[K, V]]:
        i = bisect.bisect_left(self._keys, key)
        return (self._keys[i], self._vals[i]) if i < len(self._keys) else None

    def min(self) -> Optional[Tuple[K, V]]:
        return (self._keys[0], self._vals[0]) if self._keys else None

    def max(self) -> Optional[Tuple[K, V]]:
        return (self._keys[-1], self._vals[-1]) if self._keys else None

    def items(self) -> Iterator[Tuple[K, V]]:
        return iter(zip(list(self._keys), list(self._vals)))

    def __len__(self) -> int:
        return len(self._keys)


@dataclass(order=True)
class _Interval:
    start: int
    end: int
    data: Any = field(compare=False, default=None)


class IntervalTree:
    """Interval set with stabbing/overlap queries (reference
    merge-tree/src/collections.ts IntervalTree, backing interval collections).
    Sorted-by-start array: queries bisect to prune intervals starting after
    the query range, then filter the prefix by end (O(n) worst case when many
    intervals start early; fine for interval-collection sizes)."""

    def __init__(self):
        self._intervals: List[_Interval] = []

    def put(self, start: int, end: int, data: Any = None) -> _Interval:
        iv = _Interval(start, end, data)
        bisect.insort(self._intervals, iv)
        return iv

    def remove(self, iv: _Interval) -> None:
        i = bisect.bisect_left(self._intervals, iv)
        while i < len(self._intervals):
            if self._intervals[i] is iv:
                del self._intervals[i]
                return
            if self._intervals[i].start > iv.start:
                break
            i += 1

    def overlapping(self, start: int, end: int) -> List[_Interval]:
        # Prune everything starting after `end`; filter the prefix by end.
        hi = bisect.bisect_right(self._intervals, _Interval(end, 2**62))
        return [iv for iv in self._intervals[:hi] if start <= iv.end]

    def stab(self, point: int) -> List[_Interval]:
        return self.overlapping(point, point)

    def __iter__(self) -> Iterator[_Interval]:
        return iter(list(self._intervals))

    def __len__(self) -> int:
        return len(self._intervals)
