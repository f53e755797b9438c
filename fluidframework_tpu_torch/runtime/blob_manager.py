"""BlobManager: attachment blobs uploaded outside the op stream.

Capability parity with reference container-runtime/src/blobManager.ts:42 —
binary payloads too large/opaque for ops are stored content-addressed and
referenced from DDS values by handle path ("/_blobs/<sha>"); they persist
through the summary tree and participate in GC via those handle routes.

A port of fluidframework_tpu's runtime/blob_manager.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import base64
from typing import Dict, List

from ..dds.shared_object import FluidHandle
from ..protocol.summary import SummaryTree, blob_sha

BLOBS_PATH = "_blobs"


class BlobManager:
    def __init__(self):
        self._blobs: Dict[str, bytes] = {}

    def create_blob(self, content: bytes) -> FluidHandle:
        if isinstance(content, str):
            content = content.encode()
        sha = blob_sha(content)
        self._blobs[sha] = content
        return FluidHandle(f"/{BLOBS_PATH}/{sha}", content)

    def get_blob(self, sha: str) -> bytes:
        return self._blobs[sha]

    def __len__(self) -> int:
        return len(self._blobs)

    def node_ids(self) -> List[str]:
        return [f"/{BLOBS_PATH}/{sha}" for sha in self._blobs]

    def summarize(self) -> SummaryTree:
        tree = SummaryTree()
        for sha, content in sorted(self._blobs.items()):
            # base64 keeps the summary tree JSON-safe for any byte payload.
            tree.add_blob(sha, base64.b64encode(content).decode())
        return tree

    def load(self, tree: SummaryTree) -> None:
        for sha, blob in tree.entries.items():
            self._blobs[sha] = base64.b64decode(blob.content)
