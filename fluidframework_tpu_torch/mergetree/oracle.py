"""Host-side payload types of the merge-tree oracle: `Items` only (a copy
of fluidframework_tpu's mergetree/oracle.py:85-120). The scalar
`MergeTreeOracle` itself is not ported yet."""

from __future__ import annotations


class Items:
    """A sliceable run of JSON values: the segment payload for the
    item-sequence DDSes (reference sequence/src/sharedSequence.ts
    SubSequence<T> — SharedNumberSequence / SharedObjectSequence carry
    arrays of values instead of text)."""

    __slots__ = ("values",)

    def __init__(self, values):
        self.values = tuple(values)

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return Items(self.values[key])
        return self.values[key]

    def __eq__(self, other) -> bool:
        return isinstance(other, Items) and self.values == other.values

    def __repr__(self) -> str:
        return f"Items({list(self.values)!r})"

    def encode(self) -> list:
        return list(self.values)
