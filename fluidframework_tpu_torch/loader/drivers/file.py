"""File driver: snapshots + ops on the local filesystem.

Capability parity with reference packages/drivers/file-driver
(fileDocumentService.ts): a document is a directory holding summary.json
(the summary tree) and ops.json (the sequenced op log). Reading gives a
live-loadable document; writing captures a session for later replay
(fetch-tool writes this format; replay-tool reads it).

A port of fluidframework_tpu's loader/drivers/file.py (host only). The
JSON format is the reference's byte for byte, so a capture written by one
package loads in the other. FileDeltaStorage.get re-reads the whole op
file on each call, as the reference does."""

from __future__ import annotations

import json
import os
from typing import List, Optional

from ...protocol.messages import SequencedDocumentMessage
from ...protocol.summary import (
    SummaryBlob,
    SummaryObject,
    SummaryTree,
    blob_sha,
)
from .base import (
    IDocumentDeltaStorageService,
    IDocumentService,
    IDocumentServiceFactory,
    IDocumentStorageService,
)
from .replay import ReplayController, ReplayDeltaConnection


def summary_to_json(node: SummaryObject):
    if isinstance(node, SummaryBlob):
        return {"type": "blob", "content": node.content
                if isinstance(node.content, str)
                else node.content.decode("latin-1")}
    return {"type": "tree", "entries": {
        name: summary_to_json(child)
        for name, child in node.entries.items()}}


def summary_from_json(data) -> SummaryObject:
    if data["type"] == "blob":
        return SummaryBlob(data["content"])
    tree = SummaryTree()
    for name, child in data["entries"].items():
        tree.entries[name] = summary_from_json(child)
    return tree


def message_to_json(m: SequencedDocumentMessage) -> dict:
    return {
        "clientId": m.client_id,
        "sequenceNumber": m.sequence_number,
        "minimumSequenceNumber": m.minimum_sequence_number,
        "clientSequenceNumber": m.client_sequence_number,
        "referenceSequenceNumber": m.reference_sequence_number,
        "type": m.type,
        "contents": m.contents,
        "data": m.data,
        "timestamp": m.timestamp,
    }


def message_from_json(d: dict) -> SequencedDocumentMessage:
    return SequencedDocumentMessage(
        client_id=d.get("clientId"),
        sequence_number=d["sequenceNumber"],
        minimum_sequence_number=d.get("minimumSequenceNumber", 0),
        client_sequence_number=d.get("clientSequenceNumber", 0),
        reference_sequence_number=d.get("referenceSequenceNumber", 0),
        type=d["type"],
        contents=d.get("contents"),
        data=d.get("data"),
        timestamp=d.get("timestamp", 0.0),
    )


class FileDocumentCapture:
    """Read/write access to one on-disk document directory."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    @property
    def summary_path(self) -> str:
        return os.path.join(self.directory, "summary.json")

    @property
    def ops_path(self) -> str:
        return os.path.join(self.directory, "ops.json")

    def write_summary(self, summary: SummaryTree) -> str:
        data = summary_to_json(summary)
        with open(self.summary_path, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        return blob_sha(json.dumps(data, sort_keys=True))

    def read_summary(self) -> Optional[SummaryTree]:
        if not os.path.exists(self.summary_path):
            return None
        with open(self.summary_path) as f:
            return summary_from_json(json.load(f))

    def write_ops(self, ops: List[SequencedDocumentMessage]) -> None:
        with open(self.ops_path, "w") as f:
            json.dump([message_to_json(m) for m in ops], f, indent=1)

    def append_ops(self, ops: List[SequencedDocumentMessage]) -> None:
        self.write_ops(self.read_ops() + list(ops))

    def read_ops(self) -> List[SequencedDocumentMessage]:
        if not os.path.exists(self.ops_path):
            return []
        with open(self.ops_path) as f:
            return [message_from_json(d) for d in json.load(f)]


class FileStorageService(IDocumentStorageService):
    def __init__(self, capture: FileDocumentCapture):
        self.capture = capture

    def get_summary(self, version: Optional[str] = None):
        return self.capture.read_summary()

    def upload_summary(self, summary, parent=None, initial=False) -> str:
        return self.capture.write_summary(summary)

    def get_versions(self, count: int = 1) -> List[str]:
        summary = self.capture.read_summary()
        if summary is None:
            return []
        return [blob_sha(json.dumps(summary_to_json(summary),
                                    sort_keys=True))]


class FileDeltaStorage(IDocumentDeltaStorageService):
    def __init__(self, capture: FileDocumentCapture):
        self.capture = capture

    def get(self, from_seq: int, to_seq: Optional[int] = None
            ) -> List[SequencedDocumentMessage]:
        return [m for m in self.capture.read_ops()
                if m.sequence_number > from_seq
                and (to_seq is None or m.sequence_number <= to_seq)]


class FileDocumentService(IDocumentService):
    """Read path: load summary + replay the on-disk op tail (read-only
    connection, as the reference file driver is)."""

    def __init__(self, capture: FileDocumentCapture):
        self.capture = capture

    def connect_to_storage(self):
        return FileStorageService(self.capture)

    def connect_to_delta_storage(self):
        return FileDeltaStorage(self.capture)

    def connect_to_delta_stream(self, client_details=None):
        return ReplayDeltaConnection(self.capture.read_ops(),
                                     ReplayController())


class FileDocumentServiceFactory(IDocumentServiceFactory):
    def __init__(self, root_directory: str):
        self.root = root_directory

    def create_document_service(self, document_id: str) -> IDocumentService:
        return FileDocumentService(
            FileDocumentCapture(os.path.join(self.root, document_id)))
