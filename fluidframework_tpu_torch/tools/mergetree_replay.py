"""Merge-tree client replay: re-run a merge-tree op log against test
clients.

Capability parity with reference packages/tools/merge-tree-client-replay
(494 LoC): given a recorded log of sequenced merge-tree ops, build one
replica per participating client plus a read-only observer, apply every op
from each replica's own perspective (its ops ack; others apply remote), and
assert all replicas converge — the offline debugging harness for merge-tree
divergence reports.

Log entry shape: {"op": <merge-tree wire op>, "seq": n, "refSeq": n,
"client": ordinal, "minSeq": n?} — the same fields a SequencedDocumentMessage
carries for a sequence-DDS op.

A port of fluidframework_tpu's tools/mergetree_replay.py: the replicas are
scalar MergeTreeClients (apply_msg), so the replay runs on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..mergetree.client import MergeTreeClient


class MergeTreeReplayer:
    OBSERVER = -999  # never appears as a writer ordinal

    def __init__(self):
        self.clients: Dict[int, MergeTreeClient] = {}

    def _client(self, ordinal: int) -> MergeTreeClient:
        if ordinal not in self.clients:
            self.clients[ordinal] = MergeTreeClient(client_id=ordinal)
        return self.clients[ordinal]

    def replay(self, log: List[dict]) -> str:
        """Apply the full log; returns the converged text. Raises
        AssertionError with a divergence report if replicas disagree."""
        writers = sorted({e["client"] for e in log})
        for ordinal in writers + [self.OBSERVER]:
            self._client(ordinal)
        for entry in sorted(log, key=lambda e: e["seq"]):
            self.apply(entry)
        return self.assert_converged()

    def apply(self, entry: dict) -> None:
        op, seq = entry["op"], entry["seq"]
        ref_seq = entry.get("refSeq", seq - 1)
        origin = entry["client"]
        min_seq = entry.get("minSeq")
        for ordinal, client in self.clients.items():
            if ordinal == origin:
                # The originator must hold the pending local op; recreate it
                # at its recorded refSeq perspective, then ack.
                client.tree.current_seq = ref_seq
                self._apply_local(client, op)
                client.apply_msg(op, seq, ref_seq, origin, min_seq=min_seq)
                client.tree.current_seq = seq
            else:
                client.apply_msg(op, seq, ref_seq, origin, min_seq=min_seq)

    @staticmethod
    def _apply_local(client: MergeTreeClient, op: dict) -> None:
        from ..mergetree.client import OP_ANNOTATE, OP_INSERT, OP_REMOVE
        t = op["type"]
        if t == OP_INSERT:
            seg = op["seg"]
            if seg.get("marker"):
                client.insert_marker_local(op["pos1"], seg.get("props"))
            elif "items" in seg:
                client.insert_items_local(op["pos1"], seg["items"],
                                          seg.get("props"))
            else:
                client.insert_text_local(op["pos1"], seg["text"],
                                         seg.get("props"))
        elif t == OP_REMOVE:
            client.remove_range_local(op["pos1"], op["pos2"])
        elif t == OP_ANNOTATE:
            client.annotate_range_local(op["pos1"], op["pos2"], op["props"])

    def assert_converged(self) -> str:
        """All replicas must show identical text; returns it."""
        texts = {ordinal: client.get_text()
                 for ordinal, client in self.clients.items()}
        unique = set(texts.values())
        if len(unique) > 1:
            report = "\n".join(f"  client {o}: {t!r}"
                               for o, t in sorted(texts.items()))
            raise AssertionError(f"merge-tree divergence:\n{report}")
        return next(iter(unique))


def record_from_sequence_ops(messages: List[dict]) -> List[dict]:
    """Convert captured sequence-DDS channel ops (as found in a document op
    log) into replayer entries; non-merge-tree messages are skipped."""
    out = []
    for m in messages:
        contents = m.get("contents") or {}
        inner = (contents.get("contents") or {}).get("contents")
        if not isinstance(inner, dict) or "type" not in inner:
            continue
        out.append({"op": inner, "seq": m["sequenceNumber"],
                    "refSeq": m["referenceSequenceNumber"],
                    "client": m["clientOrdinal"],
                    "minSeq": m.get("minimumSequenceNumber")})
    return out
