"""Fetch tool: download a document's snapshot + ops for offline debugging.

Capability parity with reference packages/tools/fetch-tool (1,844 LoC):
connect to any service through its driver factory, pull the latest summary
and the full (or ranged) op log, report statistics (op counts by type,
summary tree shape/sizes), and optionally write a FileDocumentCapture
directory that the replay tool / file driver can reload. A port of
fluidframework_tpu's tools/fetch_tool.py (host only).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..loader.drivers.base import IDocumentServiceFactory
from ..loader.drivers.file import FileDocumentCapture
from ..protocol.messages import SequencedDocumentMessage
from ..protocol.summary import SummaryBlob, SummaryTree, summary_tree_to_dict


@dataclass
class FetchStats:
    document_id: str
    op_count: int = 0
    first_seq: int = 0
    last_seq: int = 0
    ops_by_type: Dict[str, int] = field(default_factory=dict)
    ops_by_client: Dict[str, int] = field(default_factory=dict)
    summary_blob_count: int = 0
    summary_bytes: int = 0
    summary_paths: List[str] = field(default_factory=list)

    def report(self) -> str:
        lines = [f"document {self.document_id}:",
                 f"  ops {self.first_seq}..{self.last_seq} "
                 f"({self.op_count} total)"]
        for mtype, n in sorted(self.ops_by_type.items()):
            lines.append(f"    {mtype}: {n}")
        lines.append(f"  summary: {self.summary_blob_count} blobs, "
                     f"{self.summary_bytes} bytes")
        return "\n".join(lines)


def _walk_summary(node, path: str, stats: FetchStats) -> None:
    if isinstance(node, SummaryBlob):
        stats.summary_blob_count += 1
        content = node.content
        stats.summary_bytes += len(content if isinstance(content, (bytes,
                                                                   bytearray))
                                   else str(content).encode())
        stats.summary_paths.append(path)
    elif isinstance(node, SummaryTree):
        for name, child in node.entries.items():
            _walk_summary(child, f"{path}/{name}", stats)


def fetch_document(factory: IDocumentServiceFactory, document_id: str,
                   out_dir: Optional[str] = None,
                   from_seq: int = 0, to_seq: Optional[int] = None
                   ) -> tuple:
    """Returns (summary, ops, FetchStats); writes a capture when out_dir is
    given."""
    service = factory.create_document_service(document_id)
    storage = service.connect_to_storage()
    summary = storage.get_summary()
    ops: List[SequencedDocumentMessage] = service.connect_to_delta_storage() \
        .get(from_seq, to_seq)

    stats = FetchStats(document_id)
    stats.op_count = len(ops)
    if ops:
        stats.first_seq = ops[0].sequence_number
        stats.last_seq = ops[-1].sequence_number
    for m in ops:
        stats.ops_by_type[m.type] = stats.ops_by_type.get(m.type, 0) + 1
        client = m.client_id or "<service>"
        stats.ops_by_client[client] = stats.ops_by_client.get(client, 0) + 1
    if summary is not None:
        _walk_summary(summary, "", stats)

    if out_dir is not None:
        capture = FileDocumentCapture(out_dir)
        if summary is not None:
            capture.write_summary(summary)
        capture.write_ops(ops)
        with open(f"{out_dir}/stats.json", "w") as f:
            json.dump({"opCount": stats.op_count,
                       "opsByType": stats.ops_by_type,
                       "summaryBlobs": stats.summary_blob_count,
                       "summaryBytes": stats.summary_bytes}, f, indent=1)
    return summary, ops, stats
