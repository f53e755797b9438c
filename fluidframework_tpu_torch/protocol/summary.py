"""Summary (snapshot) tree types — the durable checkpoint format.

A copy of fluidframework_tpu's protocol/summary.py, host code that the
port keeps as its own.

Capability parity with reference
`server/routerlicious/packages/protocol-definitions/src/summary.ts:51`:
a git-like tree of blobs/trees/handles. A *handle* points at an unchanged
subtree of the previous summary so incremental summaries only upload deltas.

The content-addressed store that persists these lives in
`fluidframework_tpu.server.storage` (gitrest/historian equivalent).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Union


class SummaryType:
    TREE = "tree"
    BLOB = "blob"
    HANDLE = "handle"
    ATTACHMENT = "attachment"


@dataclass
class SummaryBlob:
    content: Union[str, bytes]
    type: str = SummaryType.BLOB


class LazySummaryBlob(SummaryBlob):
    """A blob whose content fetches on first access (lazy snapshot load:
    the reference defers 10k-char body chunks, snapshotV1.ts:33-40 +
    sequence.ts:489). isinstance(x, SummaryBlob) holds; `.content` is a
    property resolved through the fetch callable, so consumers that never
    touch a chunk never pay its transfer."""

    def __init__(self, fetch):
        # No super().__init__: `content` stays a CLASS-level property
        # (the dataclass would write an instance attribute over it).
        self._fetch = fetch
        self._content = None
        self.type = SummaryType.BLOB

    @property
    def content(self):
        if self._content is None:
            self._content = self._fetch()
        return self._content


@dataclass
class SummaryHandle:
    """Reference to a path in the *previous* summary (incremental summaries)."""

    handle: str  # path like "/dataStores/ds1/root"
    handle_type: str = SummaryType.TREE
    type: str = SummaryType.HANDLE


@dataclass
class SummaryAttachment:
    """Reference to an already-uploaded blob by storage id (blob manager)."""

    id: str
    type: str = SummaryType.ATTACHMENT


@dataclass
class SummaryTree:
    entries: Dict[str, "SummaryObject"] = field(default_factory=dict)
    type: str = SummaryType.TREE
    unreferenced: bool = False  # GC mark (reference ISummaryTree.unreferenced)

    def add_blob(self, key: str, content: Union[str, bytes]) -> "SummaryTree":
        self.entries[key] = SummaryBlob(content)
        return self

    def add_tree(self, key: str) -> "SummaryTree":
        tree = SummaryTree()
        self.entries[key] = tree
        return tree

    def add_handle(self, key: str, handle: str,
                   handle_type: str = SummaryType.TREE) -> "SummaryTree":
        self.entries[key] = SummaryHandle(handle, handle_type)
        return self


SummaryObject = Union[SummaryTree, SummaryBlob, SummaryHandle, SummaryAttachment]


def summary_tree_to_dict(node: SummaryObject):
    """Plain-dict encoding (serialization form for storage/drivers)."""
    if isinstance(node, SummaryTree):
        return {
            "type": SummaryType.TREE,
            "entries": {k: summary_tree_to_dict(v) for k, v in node.entries.items()},
            **({"unreferenced": True} if node.unreferenced else {}),
        }
    if isinstance(node, SummaryBlob):
        content = node.content
        if isinstance(content, bytes):
            return {"type": SummaryType.BLOB, "content": content.hex(), "encoding": "hex"}
        return {"type": SummaryType.BLOB, "content": content, "encoding": "utf-8"}
    if isinstance(node, SummaryHandle):
        return {"type": SummaryType.HANDLE, "handle": node.handle,
                "handleType": node.handle_type}
    if isinstance(node, SummaryAttachment):
        return {"type": SummaryType.ATTACHMENT, "id": node.id}
    raise TypeError(f"not a summary object: {type(node)!r}")


def summary_tree_from_dict(data) -> SummaryObject:
    t = data["type"]
    if t == SummaryType.TREE:
        tree = SummaryTree(unreferenced=bool(data.get("unreferenced")))
        tree.entries = {k: summary_tree_from_dict(v) for k, v in data["entries"].items()}
        return tree
    if t == SummaryType.BLOB:
        if data.get("encoding") == "hex":
            return SummaryBlob(bytes.fromhex(data["content"]))
        return SummaryBlob(data["content"])
    if t == SummaryType.HANDLE:
        return SummaryHandle(data["handle"], data.get("handleType", SummaryType.TREE))
    if t == SummaryType.ATTACHMENT:
        return SummaryAttachment(data["id"])
    raise ValueError(f"unknown summary type {t!r}")


def blob_sha(content: Union[str, bytes]) -> str:
    """Content address for blobs (git-style but sha256 of raw content)."""
    if isinstance(content, str):
        content = content.encode("utf-8")
    return hashlib.sha256(content).hexdigest()
