"""Stable-id runs: the merge-tree payload type behind SharedMatrix axes (a
copy of fluidframework_tpu's mergetree/runs.py).

A matrix axis is a merge-tree sequence of runs of stable ids (reference
packages/dds/matrix/src/permutationvector.ts:126 PermutationVector extends
Client). Runs slice like text: the device tracks only lengths and offsets,
and the payload stays on the host, so axis ops ride the same kernels as
SharedString.
"""

from __future__ import annotations

from typing import List, Tuple


class Run:
    """A sliceable run of stable ids: (base, start+k) for k < length.

    base = (nonce, per-client-run counter) makes ids globally unique and
    replica-consistent without coordination.
    """

    __slots__ = ("base", "start", "length")

    def __init__(self, base: Tuple[int, int], start: int, length: int):
        self.base = base
        self.start = start
        self.length = length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, key):
        if isinstance(key, slice):
            lo, hi, step = key.indices(self.length)
            assert step == 1
            return Run(self.base, self.start + lo, max(0, hi - lo))
        if key < 0:
            key += self.length
        return (self.base[0], self.base[1], self.start + key)

    def __eq__(self, other) -> bool:
        return (type(other) is Run and self.base == other.base
                and self.start == other.start
                and self.length == other.length)

    def __repr__(self) -> str:
        return f"Run({self.base}, {self.start}, {self.length})"

    def ids(self) -> List[Tuple[int, int, int]]:
        return [(self.base[0], self.base[1], self.start + k)
                for k in range(self.length)]

    def encode(self) -> list:
        return [self.base[0], self.base[1], self.start, self.length]

    @staticmethod
    def decode(data: list) -> "Run":
        return Run((data[0], data[1]), data[2], data[3])


def id_key(stable_id: Tuple[int, int, int]) -> str:
    return f"{stable_id[0]}.{stable_id[1]}.{stable_id[2]}"


def encode_entry_payloads(entries: List[dict]) -> List[dict]:
    """JSON-safe copies of snapshot entries: Run payloads become
    {"run": [nonce, counter, start, length]} (PermutationVector.snapshot
    wire form) and Items payloads {"items": [...]} (sharedSequence
    SubSequence wire form). Plain text passes through unchanged."""
    from .oracle import Items

    out = []
    for e in entries:
        text = e.get("text")
        if isinstance(text, Run):
            e = dict(e)
            e["text"] = {"run": text.encode()}
        elif isinstance(text, Items):
            e = dict(e)
            e["text"] = {"items": text.encode()}
        out.append(e)
    return out


def decode_entry_payloads(entries: List[dict]) -> List[dict]:
    """Inverse of encode_entry_payloads (tolerates already-decoded
    entries)."""
    from .oracle import Items

    out = []
    for e in entries:
        text = e.get("text")
        if isinstance(text, dict) and "run" in text:
            e = dict(e)
            e["text"] = Run.decode(text["run"])
        elif isinstance(text, dict) and isinstance(text.get("items"),
                                                   list):
            e = dict(e)
            e["text"] = Items(text["items"])
        out.append(e)
    return out
